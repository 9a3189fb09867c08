"""rec_tpu_torch datasets, config overrides and checkpoint reading vs
rec_tpu: the synthetic fallback bitwise, overrides equal, and a checkpoint
that rec_tpu's CheckpointManager wrote restores in the port and gives
rec_tpu's forward output within the tolerance of test_torch_models.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from rec_tpu.coding import BeamSearchCoder as JCoder
from rec_tpu.data import datasets as jdata
from rec_tpu.models.resnet_vae import BidirectionalResNetVAE as JModel
from rec_tpu.models.resnet_vae import ResNetVAEConfig as JConfig
from rec_tpu.train import CheckpointManager as JCheckpointManager
from rec_tpu.train import init_state, make_optimizer, save_model_config
from rec_tpu.train import reconcile_model_config as j_reconcile
from rec_tpu.utils.config import apply_overrides as j_apply_overrides
from rec_tpu_torch.cli.serve import Config as TServeConfig
from rec_tpu_torch.coding import BeamSearchCoder as TCoder
from rec_tpu_torch.data import datasets as tdata
from rec_tpu_torch.models.convert import load_flax_params
from rec_tpu_torch.models.resnet_vae import BidirectionalResNetVAE as TModel
from rec_tpu_torch.models.resnet_vae import ResNetVAEConfig as TConfig
from rec_tpu_torch.train import CheckpointManager as TCheckpointManager
from rec_tpu_torch.train import reconcile_model_config as t_reconcile
from rec_tpu_torch.train.msgpack import unpackb
from rec_tpu_torch.utils.config import apply_overrides as t_apply_overrides

torch.set_num_threads(2)

CFG = dict(num_res_blocks=2, deterministic_filters=12, stochastic_filters=4)
CODER = dict(kl_per_partition=3.0, n_beams=4, extra_samples=1.2,
             block_size=128, max_partitions=12)


class TestDatasets:
    @pytest.mark.parametrize("name", ["cifar10", "binarized_mnist",
                                      "imagenet64"])
    def test_synthetic_fallback_bitwise(self, name, tmp_path):
        cfg = dict(dataset=name, split="test", data_dir=str(tmp_path),
                   synthetic_size=5)
        want, wsyn = jdata.load_images(jdata.DatasetConfig(**cfg))
        got, gsyn = tdata.load_images(tdata.DatasetConfig(**cfg))
        assert wsyn and gsyn
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    def test_local_files(self, tmp_path):
        rs = np.random.RandomState(0)
        imgs = rs.randint(0, 256, (3, 8, 8, 3)).astype(np.uint8)
        np.savez(tmp_path / "cifar10_test.npz", images=imgs)
        d = tmp_path / "kodak" / "test"
        d.mkdir(parents=True)
        for i, im in enumerate(imgs):
            np.save(d / f"{i}.npy", im)
        for name in ("cifar10", "kodak"):
            cfg = dict(dataset=name, split="test", data_dir=str(tmp_path))
            want, wsyn = jdata.load_images(jdata.DatasetConfig(**cfg))
            got, gsyn = tdata.load_images(tdata.DatasetConfig(**cfg))
            assert not wsyn and not gsyn
            np.testing.assert_array_equal(got, want)

    def test_unknown_dataset_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            tdata.load_images(tdata.DatasetConfig(dataset="photo_x",
                                                  data_dir=str(tmp_path)))

    @pytest.mark.parametrize("shape,multiple", [((2, 30, 27, 3), 8),
                                                ((17, 32, 3), 2),
                                                ((1, 32, 32, 3), 2)])
    def test_normalize_and_pad(self, shape, multiple):
        x = np.random.RandomState(1).rand(*shape).astype(np.float32) * 255
        for mode in ("centered", "unit"):
            np.testing.assert_array_equal(tdata.normalize(x, mode),
                                          jdata.normalize(x, mode))
        np.testing.assert_array_equal(tdata.pad_to_multiple(x, multiple),
                                      jdata.pad_to_multiple(x, multiple))


class TestOverrides:
    TOKENS = ["with", "batch_size=4", "verify=false", "codec=rans",
              "model_cfg.num_res_blocks=2", "dataset.synthetic_size=8",
              "extra_samples=1.0", "coordinator=localhost:1234",
              "dataset.crop_size=none", "model_cfg.kernel_size=(5, 5)"]

    def test_serve_config_overrides_match(self):
        """The serve Configs share every field but the port's ``device``;
        the same tokens give the same values."""
        # Imported here: the example turns on JAX's persistent compilation
        # cache when imported, which collection must not do to every test.
        from examples.lossless.serve import Config as JServeConfig

        want = j_apply_overrides(JServeConfig(), self.TOKENS)
        got = t_apply_overrides(TServeConfig(), self.TOKENS)

        def flat(cfg):
            d = dataclasses.asdict(cfg)
            d.pop("device", None)
            d["model_cfg"].pop("learn_likelihood_scale", None)
            return d

        assert flat(got) == flat(want)
        assert got.verify is False and got.model_cfg.kernel_size == (5, 5)

    def test_unknown_key_raises(self):
        with pytest.raises(KeyError, match="nope"):
            t_apply_overrides(TServeConfig(), ["model_cfg.nope=1"])


class TestMsgpack:
    @pytest.mark.parametrize("obj", [
        0, 127, 128, -1, -33, 2 ** 40, -2 ** 40, 1.5, None, True, False,
        "", "x" * 40, "y" * 300, b"\x00\x01" * 200, [1, [2, "a"], {}],
        {"a": {"b": [1.25, -7]}, "k" * 20: list(range(20))},
        {str(i): i for i in range(20)}], ids=lambda o: type(o).__name__)
    def test_matches_msgpack(self, obj):
        assert unpackb(msgpack.packb(obj, use_bin_type=True)) == obj

    def test_ndarray_ext(self):
        a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        payload = msgpack.packb((a.shape, a.dtype.name, a.tobytes()),
                                use_bin_type=True)
        data = msgpack.packb({"w": msgpack.ExtType(1, payload)},
                             use_bin_type=True)
        got = unpackb(data)["w"]
        assert got.dtype == np.float32 and got.shape == (2, 3, 4)
        np.testing.assert_array_equal(got, a)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A TrainState saved by rec_tpu's CheckpointManager, with EMA params
    distinct from the params."""
    directory = str(tmp_path_factory.mktemp("ckpt"))
    model = JModel(cfg=JConfig(**CFG), coder=JCoder(**CODER))
    x = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32) - 0.5
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jax.random.PRNGKey(1))
    state = init_state(params, make_optimizer("adamax", 1e-3), beta=1.0)
    state = state._replace(
        step=jnp.asarray(7, jnp.int32),
        ema_params=jax.tree_util.tree_map(lambda p: p * 0.9, params))
    mgr = JCheckpointManager(directory)
    mgr.save(jax.device_get(state._replace(step=jnp.asarray(3, jnp.int32))))
    mgr.save(jax.device_get(state))
    save_model_config(directory, "resnet_vae", JConfig(**CFG))
    return directory, model, jax.device_get(state), x


class TestCheckpoint:
    def test_restores_newest_params_bitwise(self, saved):
        directory, _, state, _ = saved
        got = TCheckpointManager(directory).restore_params()
        assert got["step"] == 7
        for key, tree in (("params", state.params),
                          ("ema_params", state.ema_params)):
            want_leaves = jax.tree_util.tree_leaves_with_path(tree)
            got_leaves = dict(jax.tree_util.tree_leaves_with_path(got[key]))
            assert len(got_leaves) == len(want_leaves)
            for path, leaf in want_leaves:
                np.testing.assert_array_equal(got_leaves[path],
                                              np.asarray(leaf))

    def test_restored_model_forward_matches(self, saved):
        """EMA params restored by the port, loaded into the port's model:
        rec_tpu's forward output within test_torch_models' tolerances."""
        directory, model, state, x = saved
        want = model.apply(state.ema_params, jnp.asarray(x),
                           jax.random.PRNGKey(1))
        keys = jax.random.split(jax.random.PRNGKey(1), CFG["num_res_blocks"])
        noise = np.stack([np.asarray(jax.random.normal(k, (2, 8, 8, 4)))
                          for k in keys])
        tmodel = TModel(TConfig(**CFG), TCoder(**CODER), device="cpu")
        load_flax_params(
            tmodel, TCheckpointManager(directory).restore_params()[
                "ema_params"])
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x), noise)
        for a, b in zip(want["posterior"], got["posterior"]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-5)
        np.testing.assert_allclose(got["reconstruction"].numpy(),
                                   np.asarray(want["reconstruction"]),
                                   rtol=1e-4, atol=1e-5)

    def test_no_checkpoint(self, tmp_path):
        mgr = TCheckpointManager(str(tmp_path / "absent"))
        assert mgr.restore_params() is None and mgr.latest_step is None
        assert not os.path.exists(tmp_path / "absent")

    def test_reconcile_model_config_matches(self, saved):
        directory = saved[0]
        requested = dict(num_res_blocks=24, deterministic_filters=160,
                         stochastic_filters=4)
        want = j_reconcile(directory, "resnet_vae", JConfig(**requested))
        got = t_reconcile(directory, "resnet_vae", TConfig(**requested))
        assert dataclasses.asdict(got) == {
            k: v for k, v in dataclasses.asdict(want).items()
            if k in dataclasses.asdict(got)}
        assert got.num_res_blocks == 2 and got.deterministic_filters == 12
        other = t_reconcile(directory, "large_resnet_vae",
                            TConfig(**requested))
        assert other == TConfig(**requested)
