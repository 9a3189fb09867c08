"""rec_tpu_torch RVAE vs rec_tpu's flax model on JAX-CPU, with weights
carried over by the converter, at the tiny config of
tests/test_resnet_vae.py:14-20; and the whole slice end to end: compress ->
.rec with residual -> read -> decompress -> exact pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import BeamSearchCoder as JCoder
from rec_tpu.coding import GaussianParams as JG
from rec_tpu.models import modules as jmod
from rec_tpu.models.resnet_vae import BidirectionalResNetVAE as JModel
from rec_tpu.models.resnet_vae import ResNetVAEConfig as JConfig
from rec_tpu_torch import io as tio
from rec_tpu_torch.coding import BeamSearchCoder as TCoder
from rec_tpu_torch.coding import GaussianParams as TG
from rec_tpu_torch.device import resolve_device
from rec_tpu_torch.io import residual as tres
from rec_tpu_torch.models import modules as tmod
from rec_tpu_torch.models.convert import from_numpy_tree, load_flax_params
from rec_tpu_torch.models.resnet_vae import BidirectionalResNetVAE as TModel
from rec_tpu_torch.models.resnet_vae import ResNetVAEConfig as TConfig
from rec_tpu_torch.models.resnet_vae import latents_for_rec

torch.set_num_threads(2)

CFG = dict(num_res_blocks=2, deterministic_filters=16, stochastic_filters=4)
CODER = dict(kl_per_partition=3.0, n_beams=4, extra_samples=1.2,
             block_size=128, max_partitions=12)


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.fixture(scope="module")
def jax_model():
    model = JModel(cfg=JConfig(**CFG), coder=JCoder(**CODER))
    x = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32) - 0.5
    params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x),
                                       jax.random.PRNGKey(1)))
    keys = jax.random.split(jax.random.PRNGKey(1), CFG["num_res_blocks"])
    noise = np.stack([np.asarray(jax.random.normal(k, (2, 8, 8, 4)))
                      for k in keys])
    return model, params, x, noise


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, params, _, _ = jax_model
    model = TModel(TConfig(**CFG), TCoder(**CODER), device="cpu")
    load_flax_params(model, params)
    return model


class TestConvs:
    @pytest.mark.parametrize("kind,kernel,strides,features", [
        ("conv", (5, 5), (2, 2), 8), ("conv", (3, 3), (1, 1), 8),
        ("transpose", (5, 5), (2, 2), 3)])
    def test_conv_and_ddi_match_flax(self, kind, kernel, strides, features):
        rs = np.random.RandomState(1)
        x = rs.randn(2, 16, 16, 6).astype(np.float32)
        if kind == "conv":
            jm = jmod.ReparameterizedConv2D(features=features,
                                            kernel_size=kernel,
                                            strides=strides)
            tm = tmod.ReparameterizedConv2D(6, features, kernel, strides)
        else:
            jm = jmod.ReparameterizedConv2DTranspose(
                features=features, kernel_size=kernel, strides=strides)
            tm = tmod.ReparameterizedConv2DTranspose(6, features, kernel,
                                                     strides)
        p = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
        want_init = np.asarray(jm.apply(p, jnp.asarray(x)))
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
        with torch.no_grad():
            tm.v.copy_(torch.tensor(np.asarray(p["params"]["v"])
                                    .transpose(3, 2, 0, 1)))
            # Data-dependent init from JAX's v reproduces JAX's scales.
            tm.ddi = True
            tm(tx)
            tm.ddi = False
            assert _rel_err(tm.log_scale.numpy(),
                            p["params"]["log_scale"]) < 1e-5
            np.testing.assert_allclose(tm.bias.numpy(), p["params"]["bias"],
                                       rtol=1e-5, atol=1e-6)
            got = tm(tx).permute(0, 2, 3, 1).numpy()
        assert got.shape == want_init.shape
        assert _rel_err(got, want_init) < 1e-5
        # A second input through the carried-over parameters.
        x2 = rs.randn(1, 16, 16, 6).astype(np.float32)
        want2 = np.asarray(jm.apply(p, jnp.asarray(x2)))
        with torch.no_grad():
            tm.log_scale.copy_(torch.tensor(p["params"]["log_scale"]))
            tm.bias.copy_(torch.tensor(p["params"]["bias"]))
            got2 = tm(torch.from_numpy(x2).permute(0, 3, 1, 2))
        assert _rel_err(got2.permute(0, 2, 3, 1).numpy(), want2) < 1e-5


class TestModel:
    def test_data_dependent_init_matches(self, jax_model):
        _, params, x, noise = jax_model
        model = TModel(TConfig(**CFG), TCoder(**CODER), device="cpu")
        sd = from_numpy_tree(params)
        with torch.no_grad():
            for k, v in model.state_dict().items():
                if k.endswith(".v") or k == "generative_base":
                    v.copy_(sd[k])
        model.data_dependent_init(torch.from_numpy(x), noise)
        for k, v in model.state_dict().items():
            if k.endswith("log_scale") or k.endswith("bias"):
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=k)

    def test_forward_matches(self, jax_model, port_model):
        model, params, x, noise = jax_model
        want = model.apply(params, jnp.asarray(x), jax.random.PRNGKey(1))
        with torch.no_grad():
            got = port_model(torch.from_numpy(x), noise)
        for name in ("posterior", "prior"):
            for a, b in zip(want[name], got[name]):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["log_likelihood"].numpy(),
                                   np.asarray(want["log_likelihood"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(got["reconstruction"].numpy(),
                                   np.asarray(want["reconstruction"]),
                                   rtol=1e-4, atol=1e-5)

    def test_coder_on_exported_latents(self, jax_model):
        """JAX's posterior/prior arrays through both coders: same indices."""
        model, params, x, noise = jax_model
        out = model.apply(params, jnp.asarray(x), jax.random.PRNGKey(1))
        jc, tc = JCoder(**CODER), TCoder(**CODER)
        for g in range(CFG["num_res_blocks"]):
            post = [np.asarray(a[g, 0]) for a in out["posterior"]]
            prior = [np.asarray(a[g, 0]) for a in out["prior"]]
            want = jc.encode(JG(*map(jnp.asarray, post)),
                             JG(*map(jnp.asarray, prior)), 1234 + 7919 * g)
            got = tc.encode(TG(*map(torch.tensor, post)),
                            TG(*map(torch.tensor, prior)), 1234 + 7919 * g)
            np.testing.assert_array_equal(np.asarray(want.counts),
                                          got.counts.numpy())
            np.testing.assert_array_equal(np.asarray(want.indices),
                                          got.indices.numpy())

    def test_compress_matches_jax(self, jax_model, port_model):
        """Whole-model compress: the first res block's code is identical;
        later blocks see priors conditioned on earlier samples, which agree
        with JAX's only to float tolerance, so a late near-tie may flip.
        Floors over all blocks: counts 100%, indices 95% (measured 100%)."""
        model, params, x, _ = jax_model
        want = model.apply(params, jnp.asarray(x[:1]), 1234,
                           method=model.compress)
        got = port_model.compress(torch.from_numpy(x[:1]), 1234)
        wi, gi = np.asarray(want["indices"]), got["indices"].numpy()
        wc, gc = np.asarray(want["counts"]), got["counts"].numpy()
        np.testing.assert_array_equal(wc[0], gc[0])
        np.testing.assert_array_equal(wi[0], gi[0])
        assert np.mean(wc == gc) == 1.0
        assert np.mean(wi == gi) >= 0.95

    def test_lossless_file_round_trip(self, port_model, tmp_path):
        """The slice as a whole: compress -> write_rec with residual ->
        read_rec -> decompress -> decode_residual gives the exact pixels."""
        rs = np.random.RandomState(7)
        img01 = (rs.randint(0, 256, (1, 16, 16, 3)) + 0.5) / 256.0
        x = torch.tensor(img01 - 0.5, dtype=torch.float32)
        comp = port_model.compress(x, 99)
        recon = port_model.decompress((16, 16), comp["indices"],
                                      comp["counts"], 99)
        assert torch.equal(recon, comp["reconstruction"])
        payload, _ = tres.encode_residual(img01[0], recon[0].numpy())
        path = str(tmp_path / "img.rec")
        tio.write_rec(path, seed=99, image_shape=(16, 16, 3),
                      block_size=CODER["block_size"],
                      max_index=port_model.coder.n_samples,
                      latents=latents_for_rec(comp), residual=payload)
        seed, shape, _, latents, section = tio.read_rec(
            path, max_partitions=CODER["max_partitions"], with_residual=True)
        ind = torch.stack([torch.from_numpy(i) for i, _ in latents])
        cnt = torch.stack([torch.from_numpy(c) for _, c in latents])
        dec = port_model.decompress(shape[:2], ind, cnt, seed)
        out = tres.decode_residual(section, dec[0].numpy())
        np.testing.assert_array_equal(tres.quantize(out),
                                      tres.quantize(img01[0]))

    def test_wrong_seed_differs(self, port_model):
        x = torch.from_numpy(
            np.random.RandomState(3).rand(1, 16, 16, 3).astype(np.float32)
            - 0.5)
        comp = port_model.compress(x, 5)
        bad = port_model.decompress((16, 16), comp["indices"],
                                    comp["counts"], 6)
        assert not torch.allclose(bad, comp["reconstruction"], atol=1e-5)


def test_device_rule():
    """The card by default; the CPU only when asked; no quiet fallback."""
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TModel(TConfig(**CFG), TCoder(**CODER))


def test_uninitialised_model_refuses():
    model = TModel(TConfig(**CFG), TCoder(**CODER), device="cpu")
    with pytest.raises(RuntimeError, match="data_dependent_init"):
        model.compress(torch.zeros(1, 16, 16, 3), 0)
