"""rec_tpu_torch beam-search coder vs rec_tpu on JAX-CPU.

The scan path and the kernel's plain PyTorch version must pick rec_tpu's
indices and counts; the replay equals rec_tpu's bitwise in both
directions; the port's own round trip is bitwise.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import BeamSearchCoder as JCoder
from rec_tpu.coding import GaussianParams as JG
from rec_tpu.coding import beam_search as jbs
from rec_tpu.coding import partition as jpart
from rec_tpu.coding import rng as jrng
from rec_tpu.ops.mega_beam import mega_encode_blocks as j_mega
from rec_tpu_torch.coding import BeamSearchCoder as TCoder
from rec_tpu_torch.coding import GaussianParams as TG
from rec_tpu_torch.coding import beam_search as tbs
from rec_tpu_torch.coding import coder as tcoder
from rec_tpu_torch.coding import partition as tpart
from rec_tpu_torch.coding import rng as trng
from rec_tpu_torch.ops import mega_beam as tmb
from rec_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _ulp(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def _pair(loc, scale):
    loc, scale = np.asarray(loc, np.float32), np.asarray(scale, np.float32)
    n = loc.shape
    return ((JG(jnp.asarray(loc), jnp.asarray(scale)),
             JG(jnp.zeros(n), jnp.ones(n))),
            (TG(torch.from_numpy(loc), torch.from_numpy(scale)),
             TG(torch.zeros(n), torch.ones(n))))


def _keys(seed, n):
    root = jrng.root_key(seed)
    jk = jax.vmap(lambda b: jrng.block_key(root, b))(jnp.arange(n))
    tk = trng.block_key(trng.root_key(seed, "cpu"), torch.arange(n))
    return jk, tk


def _cfgs(**kw):
    return jbs.BeamSearchConfig(**kw), tbs.BeamSearchConfig(**kw)


class TestSchedule:
    @pytest.mark.parametrize("P", [8, 24, 88])
    @pytest.mark.parametrize("table", [False, True])
    def test_matches_jax(self, P, table):
        """The host float32 schedule against rec_tpu's on XLA-CPU: bitwise
        (0 ulp), w and c_after, every count."""
        ratios = [0.9, 0.8, 0.6, 0.5] if table else None
        jr = None if ratios is None else jnp.asarray(ratios, jnp.float32)
        fn = jax.jit(lambda c: jpart.partition_schedule(c, P, jr))
        for count in range(1, P + 1):
            w, ca = fn(count)
            tw, tca = tpart.partition_schedule(count, P, ratios)
            assert _ulp(np.asarray(w), tw).max() == 0
            assert _ulp(np.asarray(ca), tca).max() == 0
            assert np.all(tw[count:] == 0)

    @pytest.mark.parametrize("P", [300, 4096])
    def test_two_level_scan_matches_jax(self, P):
        """Past 16 x 16 partitions XLA's cumulative product recurses into a
        third scan level; sampled counts, vmapped as the replay runs it,
        bitwise."""
        counts = np.unique(np.concatenate(
            [np.arange(1, 40), np.arange(P - 40, P + 1),
             np.random.RandomState(P).randint(1, P, 40)]))
        fn = jax.jit(jax.vmap(lambda c: jpart.partition_schedule(c, P)))
        w, ca = (np.asarray(a) for a in fn(jnp.asarray(counts, jnp.int32)))
        tw, tca = tpart.schedule_table(counts, P, device="cpu")
        assert _ulp(w, tw.numpy()).max() == 0
        assert _ulp(ca, tca.numpy()).max() == 0


class TestScanPath:
    @pytest.mark.parametrize("stream", ["fmix", "threefry"])
    def test_same_indices_and_counts(self, stream):
        """tests/test_ops.py:92-103 settings."""
        rs = np.random.RandomState(0)
        N, D = 3, 40
        (jt, jc), (tt, tc) = _pair(rs.randn(N, D) * 0.4,
                                   np.exp(rs.randn(N, D) * 0.1))
        jcfg, tcfg = _cfgs(kl_per_partition=3.0, n_beams=4,
                           extra_samples=1.0, max_partitions=8,
                           stream=stream)
        jk, tk = _keys(11, N)
        want = jbs.encode_blocks(jcfg, jt, jc, jk)
        got = tbs.encode_blocks(tcfg, tt, tc, tk)
        np.testing.assert_array_equal(np.asarray(want.count),
                                      got.count.numpy())
        np.testing.assert_array_equal(np.asarray(want.indices),
                                      got.indices.numpy())



class TestSharedPool:
    """``shared_pool=True``: one candidate pool per partition shared by all
    beams (rec_tpu/coding/beam_search.py:150-173, 209-210, 381-386)."""

    @pytest.mark.parametrize("stream", ["fmix", "threefry"])
    @pytest.mark.parametrize("N,D,B,P", [(3, 40, 4, 8), (2, 128, 6, 12)])
    def test_scan_path_matches_jax(self, stream, N, D, B, P):
        """Counts equal and >= 95% of the indices (the bf16 products are
        exact, the order of the D-sums of XLA-CPU's dot is not copied)."""
        rs = np.random.RandomState(D + B)
        (jt, jc), (tt, tc) = _pair(rs.randn(N, D) * 0.4,
                                   np.exp(rs.randn(N, D) * 0.1))
        jcfg, tcfg = _cfgs(n_beams=B, max_partitions=P, stream=stream,
                           shared_pool=True)
        jk, tk = _keys(31, N)
        want = jbs.encode_blocks(jcfg, jt, jc, jk)
        got = tbs.encode_blocks(tcfg, tt, tc, tk)
        np.testing.assert_array_equal(got.count.numpy(),
                                      np.asarray(want.count))
        assert np.mean(got.indices.numpy() == np.asarray(want.indices)) >= 0.95

    @pytest.mark.parametrize("stream", ["fmix", "threefry"])
    def test_cross_decode_learned_prior(self, stream):
        """Either package's shared-pool indices replay to the same float32
        bits in both (keys pool_key(step_key), no history hash)."""
        rs = np.random.RandomState(12)
        shape = (6, 6, 8)
        c_loc = (rs.randn(*shape) * 0.5).astype(np.float32)
        c_scale = np.exp(rs.randn(*shape) * 0.5).astype(np.float32)
        t_loc = (c_loc + rs.randn(*shape) * 0.5).astype(np.float32)
        t_scale = (c_scale * 0.5).astype(np.float32)
        kw = dict(n_beams=4, block_size=64, max_partitions=8, stream=stream,
                  shared_pool=True)
        jcoder, tcoder = JCoder(**kw), TCoder(**kw)
        jc = JG(jnp.asarray(c_loc), jnp.asarray(c_scale))
        tc = TG(torch.from_numpy(c_loc), torch.from_numpy(c_scale))
        j_enc = jcoder.encode(JG(jnp.asarray(t_loc), jnp.asarray(t_scale)),
                              jc, 29)
        t_enc = tcoder.encode(TG(torch.from_numpy(t_loc),
                                 torch.from_numpy(t_scale)), tc, 29)
        np.testing.assert_array_equal(t_enc.counts.numpy(),
                                      np.asarray(j_enc.counts))
        assert np.mean(t_enc.indices.numpy()
                       == np.asarray(j_enc.indices)) >= 0.95
        for idx, cnt in ((np.asarray(j_enc.indices),
                          np.asarray(j_enc.counts)),
                         (t_enc.indices.numpy(), t_enc.counts.numpy())):
            want = np.asarray(jcoder.decode(jc, jnp.asarray(idx),
                                            jnp.asarray(cnt), 29))
            got = tcoder.decode(tc, idx, cnt, 29).numpy()
            assert _ulp(got, want).max() == 0

    def _latent(self, seed, shape, kl_scale):
        """tests/test_roundtrip.py's _random_latent."""
        k = np.random.RandomState(seed)
        return (TG(torch.tensor(kl_scale * k.randn(*shape),
                                dtype=torch.float32),
                   torch.tensor(np.exp(0.2 * k.randn(*shape) - 0.15),
                                dtype=torch.float32)),
                TG(torch.zeros(shape), torch.ones(shape)))

    def test_roundtrip(self):
        target, coder = self._latent(31, (4, 4, 130), 0.22)
        bsc = TCoder(n_beams=20, block_size=1000, max_partitions=24,
                     shared_pool=True)
        coded = bsc.encode(target, coder, 55)
        assert torch.equal(coded.sample.view(torch.int32), bsc.decode(
            coder, coded.indices, coded.counts, 55).view(torch.int32))

    def test_sample_quality(self):
        """Samples still look like target samples: a positive mean log
        density ratio."""
        bsc = TCoder(n_beams=8, extra_samples=1.5, block_size=None,
                     max_partitions=16, shared_pool=True)
        ratios = []
        for seed in range(5):
            target, coder = self._latent(seed, (24,), 0.3)
            coded = bsc.encode(target, coder, seed)
            ratios.append(float(torch.sum(target.log_prob(coded.sample)
                                          - coder.log_prob(coded.sample))))
        assert np.mean(ratios) > 0.0

    def test_distinct_stream_contract(self):
        target, coder = self._latent(32, (40,), 0.35)
        base = dict(n_beams=8, block_size=None, max_partitions=16)
        a = TCoder(**base).encode(target, coder, 7)
        b = TCoder(shared_pool=True, **base).encode(target, coder, 7)
        assert not torch.equal(a.sample, b.sample)


class TestDispatch:
    """Which encode path runs (``_use_fused``): the kernel only for CUDA
    tensors with a known stream and B, S <= 128; oversize configs warn, as
    rec_tpu does on a TPU."""

    @pytest.mark.parametrize("kw,on_cuda,fused,warns", [
        ({}, True, True, False),                               # paper
        (dict(kl_per_partition=4.5), True, False, True),       # S = 221
        (dict(n_beams=129), True, False, True),
        (dict(n_beams=128, extra_samples=1.6), True, True, False),  # 121
        (dict(stream="other"), True, False, False),
        (dict(kl_per_partition=4.5), False, False, False),     # CPU
        ({}, False, False, False),
        (dict(shared_pool=True), True, False, False),          # never
        (dict(shared_pool=True, stream="threefry"), True, False, False)])
    def test_use_fused(self, kw, on_cuda, fused, warns):
        cfg = tbs.BeamSearchConfig(**kw)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert tbs._use_fused(cfg, on_cuda) is fused
        warned = [w for w in caught if "scan path" in str(w.message)]
        assert bool(warned) == warns
        if warns:
            assert f"S={cfg.n_samples}" in str(warned[0].message)

    def test_s221_scan_encode_on_cpu_matches_jax(self):
        """The oversize config rec_tpu scans: same indices and counts, and
        the port's round trip is bitwise."""
        rs = np.random.RandomState(8)
        (jt, jc), (tt, tc) = _pair(rs.randn(2, 24) * 0.6,
                                   np.exp(rs.randn(2, 24) * 0.2))
        kw = dict(kl_per_partition=4.5, n_beams=3, max_partitions=4)
        jcfg, tcfg = _cfgs(**kw)
        assert tcfg.n_samples == 221
        jk, tk = _keys(12, 2)
        want = jbs.encode_blocks(jcfg, jt, jc, jk)
        got = tbs.encode_blocks(tcfg, tt, tc, tk)
        np.testing.assert_array_equal(np.asarray(want.count),
                                      got.count.numpy())
        np.testing.assert_array_equal(np.asarray(want.indices),
                                      got.indices.numpy())
        dec = tbs.decode_blocks(tcfg, tc, got.indices, got.count, tk)
        assert torch.equal(dec.view(torch.int32), got.sample.view(torch.int32))


class TestPlainKernelVersion:
    """``mega_encode_blocks_ref`` against rec_tpu's Pallas kernel in
    interpret mode, at the settings of tests/test_ops.py:85-225."""

    def _both(self, loc, scale, seed, ratios=None, **kw):
        (jt, jc), (tt, tc) = _pair(loc, scale)
        jk, tk = _keys(seed, loc.shape[0])
        jr = None if ratios is None else jnp.asarray(ratios, jnp.float32)
        want = j_mega(jt, jc, jk, ratios=jr, interpret=True, **kw)
        got = tmb.mega_encode_blocks_ref(tt, tc, tk, ratios=ratios, **kw)
        return [np.asarray(a) for a in want], [a.numpy() for a in got]

    def test_fitted_ratios(self):
        rs = np.random.RandomState(3)
        (wi, wc), (gi, gc) = self._both(
            rs.randn(2, 60) * 0.5, np.exp(rs.randn(2, 60) * 0.15), 17,
            ratios=[0.9, 0.8, 0.6, 0.5], kl_per_partition=3.0, n_beams=5,
            n_samples=int(np.exp(3.6)), max_partitions=16, stream="fmix")
        np.testing.assert_array_equal(wc, gc)
        np.testing.assert_array_equal(wi, gi)

    def test_needle_saturates(self):
        (wi, wc), (gi, gc) = self._both(
            np.full((1, 30), 5.1), np.full((1, 30), 1e-3), 9,
            kl_per_partition=3.0, n_beams=4, n_samples=int(np.exp(3.6)),
            max_partitions=8, stream="fmix")
        assert int(gc[0]) == 8
        np.testing.assert_array_equal(wc, gc)
        np.testing.assert_array_equal(wi, gi)

    def test_budget_past_128(self):
        """P=160: the history crosses the Pallas kernel's 128-column tile
        (the port keeps it in global memory)."""
        (wi, wc), (gi, gc) = self._both(
            np.full((1, 24), 5.1), np.full((1, 24), 1e-3), 5,
            kl_per_partition=3.0, n_beams=3, n_samples=20,
            max_partitions=160, stream="fmix")
        assert int(gc[0]) > 128
        np.testing.assert_array_equal(wc, gc)
        np.testing.assert_array_equal(wi, gi)

    @pytest.mark.parametrize("stream", ["fmix", "threefry"])
    def test_s121_omega4(self, stream):
        rs = np.random.RandomState(21)
        (wi, wc), (gi, gc) = self._both(
            rs.randn(1, 32) * 0.5, np.exp(rs.randn(1, 32) * 0.1), 13,
            kl_per_partition=4.0, n_beams=4, n_samples=121,
            max_partitions=4, stream=stream)
        np.testing.assert_array_equal(wc, gc)
        np.testing.assert_array_equal(wi, gi)

    def test_oversize_config_raises(self):
        (_, _), (tt, tc) = _pair(np.zeros((1, 8)), np.ones((1, 8)))
        with pytest.raises(ValueError, match="selection tile"):
            tmb.mega_encode_blocks(tt, tc, _keys(0, 1)[1],
                                   kl_per_partition=3.0, n_beams=4,
                                   n_samples=164, max_partitions=4,
                                   stream="fmix")

    def test_cpu_tensors_take_the_plain_version(self):
        rs = np.random.RandomState(1)
        (_, _), (tt, tc) = _pair(rs.randn(2, 16) * 0.5, np.ones((2, 16)))
        tk = _keys(4, 2)[1]
        kw = dict(kl_per_partition=3.0, n_beams=3, n_samples=8,
                  max_partitions=6, stream="fmix")
        before = profiling.counter("mega_beam.launches")
        a = tmb.mega_encode_blocks(tt, tc, tk, **kw)
        b = tmb.mega_encode_blocks_ref(tt, tc, tk, **kw)
        assert profiling.counter("mega_beam.launches") == before
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _cross_decode(rs, N, D, P, stream, loc_scale=0.5):
    """Both packages' indices, each replayed by both packages: the port's
    decode must give rec_tpu's float32 bits exactly (0 ulp)."""
    (jt, jc), (tt, tc) = _pair(rs.randn(N, D) * loc_scale,
                               np.exp(rs.randn(N, D) * 0.2))
    jcfg, tcfg = _cfgs(n_beams=4, max_partitions=P, stream=stream)
    jk, tk = _keys(21, N)
    j_enc = jbs.encode_blocks(jcfg, jt, jc, jk)
    t_enc = tbs.encode_blocks(tcfg, tt, tc, tk)
    for idx, cnt in ((np.asarray(j_enc.indices), np.asarray(j_enc.count)),
                     (t_enc.indices.numpy(), t_enc.count.numpy())):
        want = np.asarray(jbs.decode_blocks(jcfg, jc, jnp.asarray(idx),
                                            jnp.asarray(cnt), jk))
        got = tbs.decode_blocks(tcfg, tc, torch.tensor(idx),
                                torch.tensor(cnt), tk).numpy()
        assert _ulp(got, want).max() == 0
    return (jt, jc), (tt, tc), tcfg, tk, t_enc


class TestReplay:
    """Decode interop: the port replays rec_tpu's indices to rec_tpu's
    float32 bits, and rec_tpu replays the port's to the port's (0 ulp)."""

    @pytest.mark.parametrize("stream", ["fmix", "threefry"])
    def test_cross_decode(self, stream):
        _, (tt, tc), tcfg, tk, t_enc = _cross_decode(
            np.random.RandomState(5), 4, 50, 10, stream)
        # The single-block views are the batched paths at N=1, bit for bit.
        one = tbs.encode_block(tcfg, TG(tt.loc[2], tt.scale[2]),
                               TG(tc.loc[2], tc.scale[2]), tk[2])
        assert torch.equal(one.indices, t_enc.indices[2])
        dec = tbs.decode_block(tcfg, TG(tc.loc[2], tc.scale[2]),
                               t_enc.indices[2], t_enc.count[2], tk[2])
        assert torch.equal(dec, tbs.decode_blocks(
            tcfg, tc, t_enc.indices, t_enc.count, tk)[2])

    @pytest.mark.parametrize("P", [8, 24, 88])
    @pytest.mark.parametrize("stream", ["fmix", "threefry"])
    def test_cross_decode_budgets(self, stream, P):
        """Budgets below, at and past the 16-step tile of XLA's cumulative
        product; a wide target so most blocks use the whole budget."""
        _cross_decode(np.random.RandomState(P), 3, 40, P, stream,
                      loc_scale=0.15 * P ** 0.5)


    @pytest.mark.parametrize("stream", ["fmix", "threefry"])
    @pytest.mark.parametrize("shape", [(1, 1, 8), (4, 4, 16), (6, 6, 8)])
    def test_cross_decode_learned_prior(self, stream, shape):
        """A coder with non-zero locs and non-unit scales, as the models'
        priors are, through the public (jitted) coders: XLA-CPU contracts
        the replay's last scale * acc + loc into one fused multiply-add,
        and the port's decode gives rec_tpu's bits (0 ulp) for either
        package's indices."""
        rs = np.random.RandomState(11)
        c_loc = (rs.randn(*shape) * 0.5).astype(np.float32)
        c_scale = np.exp(rs.randn(*shape) * 0.5).astype(np.float32)
        t_loc = (c_loc + rs.randn(*shape) * 0.5).astype(np.float32)
        t_scale = (c_scale * 0.5).astype(np.float32)
        kw = dict(n_beams=4, block_size=64, max_partitions=8, stream=stream)
        jcoder, tcoder = JCoder(**kw), TCoder(**kw)
        jc = JG(jnp.asarray(c_loc), jnp.asarray(c_scale))
        tc = TG(torch.from_numpy(c_loc), torch.from_numpy(c_scale))
        j_enc = jcoder.encode(JG(jnp.asarray(t_loc), jnp.asarray(t_scale)),
                              jc, 23)
        t_enc = tcoder.encode(TG(torch.from_numpy(t_loc),
                                 torch.from_numpy(t_scale)), tc, 23)
        for idx, cnt in ((np.asarray(j_enc.indices),
                          np.asarray(j_enc.counts)),
                         (t_enc.indices.numpy(), t_enc.counts.numpy())):
            want = np.asarray(jcoder.decode(jc, jnp.asarray(idx),
                                            jnp.asarray(cnt), 23))
            got = tcoder.decode(tc, idx, cnt, 23).numpy()
            assert _ulp(got, want).max() == 0


class TestCoder:
    def _latent(self, seed=0, shape=(6, 6, 8)):
        rs = np.random.RandomState(seed)
        return _pair(rs.randn(*shape) * 0.5, np.exp(rs.randn(*shape) * 0.2))

    def test_round_trip_bitwise_and_matches_jax(self):
        (jt, jc), (tt, tc) = self._latent()
        kw = dict(n_beams=4, block_size=100, max_partitions=8)
        want = JCoder(**kw).encode(jt, jc, 7)
        coder = TCoder(**kw)
        got = coder.encode(tt, tc, 7)
        np.testing.assert_array_equal(np.asarray(want.indices),
                                      got.indices.numpy())
        np.testing.assert_array_equal(np.asarray(want.counts),
                                      got.counts.numpy())
        dec = coder.decode(tc, got.indices, got.counts, 7)
        assert torch.equal(dec.view(torch.int32),
                           got.sample.view(torch.int32))
        assert _ulp(dec.numpy(), np.asarray(want.sample)).max() == 0

    def test_wrong_seed_differs(self):
        (_, _), (tt, tc) = self._latent(1)
        coder = TCoder(n_beams=4, block_size=100, max_partitions=8)
        enc = coder.encode(tt, tc, 7)
        bad = coder.decode(tc, enc.indices, enc.counts, 8)
        assert not torch.allclose(bad, enc.sample, atol=1e-3)

    def test_over_budget_clamps(self):
        shape = (2, 30)
        (_, _), (tt, tc) = _pair(np.full(shape, 5.1), np.full(shape, 1e-3))
        coder = TCoder(n_beams=4, block_size=30, max_partitions=8)
        enc = coder.encode(tt, tc, 3)
        assert enc.counts.tolist() == [8, 8]
        assert coder.required_partitions(tt, tc, 3) > 8
        dec = coder.decode(tc, enc.indices, enc.counts, 3)
        assert torch.equal(dec, enc.sample)

    def test_required_partitions_neg_inf_kl(self, monkeypatch):
        (_, _), (tt, tc) = self._latent(2)
        coder = TCoder(n_beams=4, block_size=100, max_partitions=8)
        monkeypatch.setattr(
            tcoder, "block_kl",
            lambda t, c: torch.full((t.loc.shape[0],), -torch.inf))
        assert coder.required_partitions(tt, tc, 0) == 1

