"""rec_tpu_torch batched serving vs rec_tpu on JAX-CPU: the batched coder
(one block-codec call over every image's blocks) against per-image encode,
``compress_batch`` against rec_tpu's ``make_batch_compress`` with imported
weights, the serve CLI in one process, in two over Gloo and on two mesh
entries of one process (against both, and against rec_tpu's CLI at
``n_devices=2``), and the process-group and mesh helpers."""

import importlib.util
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import BeamSearchCoder as JCoder
from rec_tpu.models.resnet_vae import BidirectionalResNetVAE as JModel
from rec_tpu.models.resnet_vae import ResNetVAEConfig as JConfig
from rec_tpu.parallel import make_batch_compress as j_make_batch_compress
from rec_tpu.train import CheckpointManager as JCheckpointManager
from rec_tpu.train import init_state, make_optimizer
from rec_tpu_torch.cli import serve
from rec_tpu_torch.coding import BeamSearchCoder as TCoder
from rec_tpu_torch.coding import GaussianParams as TG
from rec_tpu_torch.coding import beam_search as tbs
from rec_tpu_torch.data.datasets import DatasetConfig, load_images, normalize
from rec_tpu_torch.io import read_rec
from rec_tpu_torch.io.residual import decode_residual, quantize
from rec_tpu_torch.models.convert import load_flax_params
from rec_tpu_torch.models.resnet_vae import BidirectionalResNetVAE as TModel
from rec_tpu_torch.models.resnet_vae import ResNetVAEConfig as TConfig
from rec_tpu_torch.parallel import (init_distributed, local_rows,
                                    make_batch_compress,
                                    make_batch_decompress, rank, world_size)
from rec_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_res_blocks=2, deterministic_filters=12, stochastic_filters=4)
CODER = dict(kl_per_partition=3.0, n_beams=4, extra_samples=1.2,
             block_size=128, max_partitions=12)
# The tiny serving settings of tests/test_multihost.py.
TINY = ["model_cfg.num_res_blocks=2", "model_cfg.deterministic_filters=8",
        "model_cfg.stochastic_filters=4", "n_beams=3", "extra_samples=1.0",
        "block_size=64", "max_partitions=6", "batch_size=4", "num_images=6",
        "codec=rans", "dataset.synthetic_size=8"]


def _latents(B=3, shape=(6, 6, 8), seed=0):
    rs = np.random.RandomState(seed)
    loc = torch.tensor(rs.randn(B, *shape) * 0.5, dtype=torch.float32)
    scale = torch.tensor(np.exp(rs.randn(B, *shape) * 0.2),
                         dtype=torch.float32)
    return (TG(loc, scale),
            TG(torch.zeros_like(loc), torch.ones_like(scale)))


class TestBatchedCoder:
    @pytest.mark.parametrize("stream", ["fmix", "threefry"])
    def test_encode_batch_equals_per_image_encode(self, stream):
        """Indices, counts and samples of every image bitwise those of a
        per-image encode with its seed; decode_batch replays them."""
        t, c = _latents()
        coder = TCoder(n_beams=4, block_size=100, max_partitions=8,
                       stream=stream)
        seeds = [7, 108, 2 ** 31 + 5]
        out = coder.encode_batch(t, c, seeds)
        assert out.indices.shape == (3, 3, 8) and out.counts.shape == (3, 3)
        for i, s in enumerate(seeds):
            one = coder.encode(TG(t.loc[i], t.scale[i]),
                               TG(c.loc[i], c.scale[i]), s)
            assert torch.equal(one.indices, out.indices[i])
            assert torch.equal(one.counts, out.counts[i])
            assert torch.equal(one.sample.view(torch.int32),
                               out.sample[i].view(torch.int32))
        dec = coder.decode_batch(c, out.indices, out.counts, seeds)
        assert torch.equal(dec.view(torch.int32),
                           out.sample.view(torch.int32))

    def test_one_block_codec_call_per_batch(self, monkeypatch):
        """Three images of 3 blocks each: one encode_blocks call over a flat
        axis of 9 blocks (one kernel launch on the card)."""
        t, c = _latents()
        coder = TCoder(n_beams=4, block_size=100, max_partitions=8)
        calls = []
        real = tbs.encode_blocks
        monkeypatch.setattr(tbs, "encode_blocks", lambda *a, **k: (
            calls.append(tuple(a[1].loc.shape)) or real(*a, **k)))
        coder.encode_batch(t, c, [1, 2, 3])
        assert calls == [(9, 100)]

    def test_per_image_ratio_tables_raise(self):
        t, c = _latents(B=2)
        coder = TCoder(n_beams=4, block_size=100, max_partitions=8,
                       aux_variance_ratios=((0.9, 0.8), (0.7, 0.6)))
        with pytest.raises(NotImplementedError, match="per-image"):
            coder.encode_batch(t, c, [1, 2])

    def test_shared_table_matches_per_image(self):
        t, c = _latents(B=2, seed=4)
        coder = TCoder(n_beams=4, block_size=100, max_partitions=8,
                       aux_variance_ratios=(0.9, 0.8, 0.6, 0.5))
        out = coder.encode_batch(t, c, [3, 4])
        one = coder.encode(TG(t.loc[1], t.scale[1]),
                           TG(c.loc[1], c.scale[1]), 4)
        assert torch.equal(one.indices, out.indices[1])
        assert torch.equal(one.sample, out.sample[1])


@pytest.fixture(scope="module")
def models():
    jmodel = JModel(cfg=JConfig(**CFG), coder=JCoder(**CODER))
    x = np.random.RandomState(0).rand(3, 16, 16, 3).astype(np.float32) - 0.5
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.asarray(x[:2]),
                                        jax.random.PRNGKey(1)))
    tmodel = TModel(TConfig(**CFG), TCoder(**CODER), device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel, x


class TestBatchedModel:
    def test_compress_batch_matches_jax(self, models):
        """rec_tpu's vmapped compress and the port's compress_batch on the
        same weights: counts equal everywhere, the first res block's
        indices identical, later blocks (whose priors agree only to float
        tolerance) >= 95% of indices equal, as for ``compress``."""
        jmodel, params, tmodel, x = models
        seeds = np.array([1234, 1335, 1436], np.int32)
        want = j_make_batch_compress(jmodel)(params, jnp.asarray(x),
                                             jnp.asarray(seeds))
        got = make_batch_compress(tmodel)(x, seeds)
        wi, gi = np.asarray(want["indices"]), got["indices"].numpy()
        wc, gc = np.asarray(want["counts"]), got["counts"].numpy()
        assert gi.shape == wi.shape and gc.shape == wc.shape
        assert got["reconstruction"].shape == want["reconstruction"].shape
        np.testing.assert_array_equal(wc[:, 0], gc[:, 0])
        np.testing.assert_array_equal(wi[:, 0], gi[:, 0])
        assert np.mean(wc == gc) == 1.0
        assert np.mean(wi == gi) >= 0.95

    def test_batch_equals_single_image_programs(self, models):
        """Image i of compress_batch codes as compress(image i, seeds[i])
        and decodes through the canonical decompress and decompress_batch
        to the same reconstruction."""
        _, _, tmodel, x = models
        seeds = [11, 112, 213]
        out = tmodel.compress_batch(torch.from_numpy(x), seeds)
        for i, s in enumerate(seeds):
            one = tmodel.compress(torch.from_numpy(x[i:i + 1]), s)
            np.testing.assert_array_equal(one["counts"].numpy(),
                                          out["counts"][i].numpy())
            assert np.mean(one["indices"].numpy()
                           == out["indices"][i].numpy()) >= 0.95
            rec = tmodel.decompress((16, 16), out["indices"][i],
                                    out["counts"][i], s)
            np.testing.assert_allclose(rec[0].numpy(),
                                       out["reconstruction"][i].numpy(),
                                       atol=1e-5)
        dec = make_batch_decompress(tmodel, (16, 16))(
            out["indices"], out["counts"], seeds)
        assert dec.shape == (3, 1, 16, 16, 3)
        np.testing.assert_allclose(dec[:, 0].numpy(),
                                   out["reconstruction"].numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def gloo_serve(tmp_path_factory):
    """The serve CLI as two processes over Gloo on the CPU, one device
    each: (output directory, the processes' outputs, the shared args)."""
    out_dir = tmp_path_factory.mktemp("gloo_serve")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    args = TINY + [f"output_dir={out_dir}",
                   f"model_save_dir={out_dir}/ckpt", "device=cpu",
                   f"coordinator=localhost:{port}", "num_processes=2"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rec_tpu_torch.cli.serve", *args,
         f"process_id={i}"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return out_dir, outs, args


def _rec_bytes(out_dir) -> dict:
    return {f: (out_dir / f).read_bytes() for f in sorted(os.listdir(out_dir))
            if f.endswith(".rec")}


class TestServeCli:
    def test_single_process(self, tmp_path):
        stats = serve.main(TINY + [f"output_dir={tmp_path}",
                                   f"model_save_dir={tmp_path}/ckpt",
                                   "device=cpu"])
        recs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".rec"))
        assert recs == [f"img_{i}.rec" for i in range(6)]
        assert stats["images"] == 6 and stats["steady_images"] == 2
        assert stats["synthetic"] and not stats["restored"]

    def test_two_devices_write_the_two_process_files(self, tmp_path,
                                                     gloo_serve):
        """``device=cpu n_devices=2``: one process serves each batch's rows
        on two mesh entries at the per-device batch of the two-process run,
        so every file is byte-identical to that run's; every file is
        verified."""
        gloo_dir, _, _ = gloo_serve
        stats = serve.main(TINY + [f"output_dir={tmp_path}",
                                   f"model_save_dir={tmp_path}/ckpt",
                                   "device=cpu", "n_devices=2"])
        assert stats["mesh"] == ["cpu", "cpu"] and stats["images"] == 6
        mine = _rec_bytes(tmp_path)
        assert sorted(mine) == [f"img_{i}.rec" for i in range(6)]
        assert mine == _rec_bytes(gloo_dir)

    def test_more_devices_than_visible_raise(self, tmp_path, monkeypatch):
        """One visible card (mocked): ``n_devices=2`` raises before any
        work, where rec_tpu's make_mesh would quietly take one card."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="1 visible"):
            serve.main(TINY + ["n_devices=2", f"output_dir={tmp_path}",
                               "device=cuda"])

    @pytest.mark.parametrize("device,n,pid,world,want", [
        ("cuda", 0, 0, 1, ["cuda:0", "cuda:1", "cuda:2"]),
        ("cuda", 2, 0, 1, ["cuda:0", "cuda:1"]),
        ("cuda:1", 0, 0, 1, ["cuda:1"]),
        ("cpu", 0, 0, 1, ["cpu"]),
        ("cpu", 3, 0, 1, ["cpu"] * 3),
        ("cuda", 0, 1, 2, ["cuda:1"]),
        ("cuda", 2, 4, 5, None),
        ("cuda:0", 2, 0, 1, None)])
    def test_serving_mesh(self, monkeypatch, device, n, pid, world, want):
        """Three visible cards (mocked): one process takes ``n_devices``
        of them (0 = all) or the card it names; in a multi-process run
        each process keeps its own card and ``n_devices`` is 0 or the
        process count."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
        if want is None:
            with pytest.raises(ValueError):
                serve.serving_mesh(device, n, pid, world)
            return
        mesh = serve.serving_mesh(device, n, pid, world)
        assert [str(d) for d in mesh] == want

    def test_two_processes_over_gloo(self, gloo_serve):
        """Two processes share each global batch; every file is written
        exactly once and one process decodes all of them to exact
        pixels."""
        tmp_path, outs, args = gloo_serve
        recs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".rec"))
        assert recs == [f"img_{i}.rec" for i in range(6)], recs
        counts = [int(out.split("served ")[1].split(" images")[0])
                  for out in outs]
        # Batch 4 over 2 processes: rows 0-1 and 2-3 of each batch; the
        # tail batch's rows 2-3 are padding.
        assert counts == [4, 2], counts
        assert all("verified" in out for out in outs)

        # One process decodes every file, whichever process wrote it.
        cfg = serve.apply_overrides(serve.Config(), args[:-2])
        model, _ = serve.load_model(
            cfg, serve.build_coder(cfg),
            normalize(load_images(DatasetConfig(
                dataset="cifar10", split="test", synthetic_size=8))[0],
                "centered")[:1].astype(np.float32), "cpu")
        images = normalize(load_images(DatasetConfig(
            dataset="cifar10", split="test", synthetic_size=8))[0],
            "centered")[:6]
        scale = float(torch.exp(model.likelihood_log_scale.detach()))
        for i in range(6):
            seed, shape, _, lat, res = read_rec(
                str(tmp_path / f"img_{i}.rec"), max_partitions=6,
                with_residual=True)
            assert seed == 42 + 101 * i
            ind = np.stack([a for a, _ in lat])
            cnt = np.stack([c for _, c in lat])
            recon = model.decompress(shape[:2], ind, cnt, seed)[0].numpy()
            out01 = decode_residual(res, recon, scale)
            np.testing.assert_array_equal(quantize(out01),
                                          quantize(images[i] + 0.5))


@pytest.fixture(scope="module")
def reference_serve(tmp_path_factory):
    """examples/lossless/serve.py as a module (its JAX compilation cache a
    temporary one, JAX's setting put back) and a rec_tpu checkpoint of the
    tiny serving model that both CLIs restore."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    old = os.environ.get("REC_TPU_COMPILATION_CACHE")
    old_dir = jax.config.jax_compilation_cache_dir
    os.environ["REC_TPU_COMPILATION_CACHE"] = cache
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_serve",
            os.path.join(REPO, "examples", "lossless", "serve.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod   # its dataclasses look it up
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        if old is None:
            os.environ.pop("REC_TPU_COMPILATION_CACHE")
        else:
            os.environ["REC_TPU_COMPILATION_CACHE"] = old
    ckpt = str(tmp_path_factory.mktemp("serve_ckpt"))
    model = JModel(cfg=JConfig(num_res_blocks=2, deterministic_filters=8,
                               stochastic_filters=4), coder=JCoder())
    # Data-dependent init on image-like inputs (an all-zero batch would
    # blow the layers' scales up and saturate every block at any budget).
    x = jnp.asarray(np.random.RandomState(0).uniform(-0.5, 0.5,
                                                     (4, 32, 32, 3)),
                    jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x,
                                 jax.random.PRNGKey(1))
    state = init_state(params, make_optimizer("adamax", 1e-3), beta=1.0)
    JCheckpointManager(ckpt).save(jax.device_get(state))
    return mod, ckpt


class TestServeSamplers:
    """``sampler=importance`` and ``shared_pool=true`` through both serve
    CLIs on one rec_tpu checkpoint: every file verified, and the files'
    seeds, counts and indices those of rec_tpu's.  The checkpoint's blocks
    need 1-3 partitions, below the budget of 6, so the counts are the
    coders' own.  The models' passes agree only to float tolerance (C4),
    which could flip a near-tie choice; on these inputs no index differs
    (measured on the CPU, both options)."""

    @pytest.mark.parametrize("option", [["sampler=importance",
                                         "coding_bits=6"],
                                        ["shared_pool=true"]])
    def test_files_match_jax(self, tmp_path, reference_serve, option):
        jserve, ckpt = reference_serve
        args = TINY + option + [f"model_save_dir={ckpt}"]
        jserve.main(args + [f"output_dir={tmp_path}/jax", "n_devices=1"])
        stats = serve.main(args + [f"output_dir={tmp_path}/torch",
                                   "device=cpu"])
        assert stats["restored"] and stats["images"] == 6
        counts = []
        for i in range(6):
            j = read_rec(str(tmp_path / "jax" / f"img_{i}.rec"),
                         max_partitions=6)
            t = read_rec(str(tmp_path / "torch" / f"img_{i}.rec"),
                         max_partitions=6)
            assert t[0] == j[0] == 42 + 101 * i
            for (ja, jc), (ta, tc) in zip(j[3], t[3]):
                np.testing.assert_array_equal(tc, jc)
                np.testing.assert_array_equal(ta, ja)
                counts.append(tc)
        counts = np.concatenate(counts)
        print(f"{option[0]}: counts {np.bincount(counts).tolist()}")
        assert counts.max() < 6


def test_two_devices_match_jax(tmp_path, reference_serve):
    """``n_devices=2`` through both serve CLIs on one rec_tpu checkpoint:
    rec_tpu's program sharded over two CPU devices and the port's two mesh
    entries.  The bar of the batched compress against rec_tpu's (C4): each
    file's seed, the first res block's counts and indices and every count
    equal, and >= 95% of all indices."""
    jserve, ckpt = reference_serve
    args = TINY + [f"model_save_dir={ckpt}", "n_devices=2"]
    jserve.main(args + [f"output_dir={tmp_path}/jax"])
    stats = serve.main(args + [f"output_dir={tmp_path}/torch", "device=cpu"])
    assert stats["restored"] and stats["images"] == 6
    same = total = 0
    for i in range(6):
        j = read_rec(str(tmp_path / "jax" / f"img_{i}.rec"),
                     max_partitions=6)
        t = read_rec(str(tmp_path / "torch" / f"img_{i}.rec"),
                     max_partitions=6)
        assert t[0] == j[0] == 42 + 101 * i
        np.testing.assert_array_equal(t[3][0][0], j[3][0][0])
        for (ja, jc), (ta, tc) in zip(j[3], t[3]):
            np.testing.assert_array_equal(tc, jc)
            same += int(np.sum(ta == ja))
            total += ta.size
    assert same / total >= 0.95


class TestProcessGroup:
    @pytest.mark.parametrize("address,host", [
        ("localhost:1234", "localhost"), ("127.0.0.1:80", "127.0.0.1"),
        ("[::1]:1234", "::1"), ("10.0.0.2:99", "10.0.0.2")])
    def test_host_strips_ipv6_brackets(self, address, host):
        assert tmesh._host(address) == host
        assert (host in tmesh._LOOPBACK) == (host != "10.0.0.2")

    @pytest.mark.parametrize("device,pid,want", [
        ("cuda", 0, "cuda:0"), ("cuda", 5, "cuda:1"),
        ("cuda:2", 3, "cuda:2"), ("cpu", 3, "cpu")])
    def test_process_device(self, monkeypatch, device, pid, want):
        """``device=cuda`` gives process ``pid`` card ``pid % count`` (4
        cards here); a named device is kept."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert serve.process_device(device, pid) == torch.device(want)

    def test_single_process_is_a_no_op(self):
        init_distributed("localhost:1", 1, 0)
        assert rank() == 0 and world_size() == 1

    @pytest.mark.parametrize("world", [1, 2, 4])
    def test_local_rows_partition_the_batch(self, world):
        rows = [list(local_rows(8, r, world)) for r in range(world)]
        assert sum(rows, []) == list(range(8))
        assert len({len(r) for r in rows}) == 1

    def test_local_rows_rejects_uneven_batch(self):
        with pytest.raises(ValueError):
            local_rows(6, 0, 4)
