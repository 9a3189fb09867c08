"""rec_tpu_torch's importance coder (GaussianCoder) and the code-length sum
vs rec_tpu on JAX-CPU: XLA-CPU's summation order, the bulk generators
(int32 fmix bits, the normal table, JAX's Gumbel draws), the replay bitwise
in both directions (fmix and threefry, a learned prior, a ratio table), the
encode's counts and indices, the single-shot coder with finite alpha and a
custom weighting, the memory groups, and rec_tpu's round-trip properties."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import CodedLatent as JCoded
from rec_tpu.coding import GaussianCoder as JGC
from rec_tpu.coding import GaussianParams as JG
from rec_tpu.coding import importance as jimp
from rec_tpu.coding import rng as jrng
from rec_tpu_torch.coding import CodedLatent as TCoded
from rec_tpu_torch.coding import CodingError
from rec_tpu_torch.coding import GaussianCoder as TGC
from rec_tpu_torch.coding import GaussianParams as TG
from rec_tpu_torch.coding import importance as timp
from rec_tpu_torch.coding import rng as trng
from rec_tpu_torch.coding.utils import sum_in_order, xla_sum_f32
from rec_tpu_torch.ops.threefry_normal import bits_to_normal, fma_f32_exact

torch.set_num_threads(2)

RATIOS = tuple(float((i + 1.0) ** -0.7) for i in range(16))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _prior_pair(shape, seed):
    """A learned-prior-like coder (non-zero loc, non-unit scale) and a
    target around it, as float32 numpy."""
    rs = np.random.RandomState(seed)
    c_loc = (rs.randn(*shape) * 0.5).astype(np.float32)
    c_scale = np.exp(rs.randn(*shape) * 0.5).astype(np.float32)
    t_loc = (c_loc + rs.randn(*shape) * 0.5 * c_scale).astype(np.float32)
    t_scale = (c_scale * 0.5).astype(np.float32)
    return (t_loc, t_scale), (c_loc, c_scale)


def _both(pair):
    (loc, scale) = pair
    return (JG(jnp.asarray(loc), jnp.asarray(scale)),
            TG(torch.from_numpy(loc), torch.from_numpy(scale)))


def _keys(seed, n):
    root = jrng.root_key(seed)
    jk = jax.vmap(lambda b: jrng.block_key(root, b))(jnp.arange(n))
    tk = trng.block_key(trng.root_key(seed, "cpu"), torch.arange(n))
    return jk, tk


class TestXlaSum:
    @pytest.mark.parametrize("n", [1, 20, 32, 33, 64, 197, 302, 1500, 5000,
                                   40000])
    def test_matches_jnp_sum(self, n):
        """XLA-CPU's order at 1-3 levels of windows: code-length-like sums
        (count * float32 ln 36) and wide random values, bitwise."""
        rs = np.random.RandomState(n)
        for v in (rs.randint(1, 25, n) * np.float32(np.log(36)),
                  rs.randn(n) * 100):
            v = v.astype(np.float32)
            want = np.asarray(jax.jit(jnp.sum)(jnp.asarray(v)))
            assert _bits(xla_sum_f32(torch.from_numpy(v))) == _bits(want)

    @pytest.mark.parametrize("D", [20, 33, 1000])
    def test_row_sums_match_jnp_sum(self, D):
        """Row sums of a (C, D) array reduce each row by the same rule (the
        importance coder's weights)."""
        x = np.random.RandomState(D).randn(64, D).astype(np.float32)
        want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(x))
        got = xla_sum_f32(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))

    @pytest.mark.parametrize("D", [7, 32, 33, 100, 1000, 1100])
    def test_window_major_layout(self, D):
        """The encode's laid-out rows add to ``xla_sum_f32`` of the rows."""
        x = torch.from_numpy(
            np.random.RandomState(D).randn(5, D).astype(np.float32))
        layout = timp._Layout(D, "cpu")
        got = xla_sum_f32(sum_in_order(layout.gather(x), -2))
        assert torch.equal(got.view(torch.int32),
                           xla_sum_f32(x).view(torch.int32))


class TestCodelength:
    @pytest.mark.parametrize("bits", [6, 8, 12])
    @pytest.mark.parametrize("n", [1, 9, 33, 197, 302])
    def test_matches_jax_bitwise(self, bits, n):
        """count * coding_bits * ln 2 per block and the latent's sum:
        rec_tpu's float32 bits, past 32 blocks too."""
        counts = np.random.RandomState(n).randint(1, 25, n).astype(np.int32)
        jc, tc = JGC(coding_bits=bits), TGC(coding_bits=bits)
        want = np.asarray(jimp.codelength_nats(jc._cfg(),
                                               jnp.asarray(counts)))
        got = timp.codelength_nats(tc._cfg(), torch.from_numpy(counts))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        want_sum = np.asarray(jc.codelength_nats(
            JCoded(None, jnp.asarray(counts), None)))
        got_sum = tc.codelength_nats(TCoded(None, torch.from_numpy(counts),
                                            None))
        assert _bits(got_sum.numpy()) == _bits(want_sum)


class TestGenerators:
    def test_fmix_bits_i32(self):
        """The int32 fmix core, from pre-multiplied counters, gives
        rec_tpu's uint32 bits as int32, wrapping multiplies and negative
        words included."""
        ctr = np.arange(300000, dtype=np.int64) * 7919 + 12345
        for k1, k2 in ((0xDEADBEEF, 0x12345678), (0, 0xFFFFFFFF), (7, 1)):
            want = np.asarray(jrng.fmix_bits(
                jnp.uint32(k1), jnp.uint32(k2),
                jnp.asarray(ctr % 2 ** 32, jnp.uint32)))
            got = trng.fmix_bits_i32(
                trng.as_i32(k1), trng.as_i32(k2),
                trng.fmix_golden_i32(torch.from_numpy(ctr)))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want.view(np.int32))

    def test_normal_table_is_the_map(self):
        """The streams' normal map (a gather from the 2^23-entry table)
        equals ``bits_to_normal`` on int64 and int32 bits, both ends of the
        range included."""
        rs = np.random.RandomState(0)
        b = torch.from_numpy(np.concatenate([
            rs.randint(0, 2 ** 32, 200000, dtype=np.int64),
            [0, 511, 512, 2 ** 32 - 1, 2 ** 31, 2 ** 31 - 1]]))
        want = bits_to_normal(b)
        assert torch.equal(trng._bits_to_normal_f32(b), want)
        assert torch.equal(trng._bits_to_normal_f32(trng.as_i32(b)), want)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_gumbel_is_jax(self, seed):
        jk = jax.random.fold_in(jrng.root_key(seed), 77)
        want = np.asarray(jax.random.gumbel(jk, (5000,)))
        got = trng.gumbel(trng.fold_in(trng.root_key(seed, "cpu"), 77), 5000)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _coders(**kw):
    return JGC(**kw), TGC(**kw)


SMALL = dict(coding_bits=8, candidate_chunk=64, block_size=100,
             max_partitions=16)


class TestCoder:
    @pytest.mark.parametrize("stream", ["fmix", "threefry"])
    @pytest.mark.parametrize("table", [False, True])
    def test_matches_jax(self, stream, table):
        """A learned prior, both streams, with and without a ratio table:
        counts equal, indices equal, each package's indices replayed by
        both to the same float32 bits, and the port's round trip
        bitwise."""
        tgt, cod = _prior_pair((6, 6, 8), 3)
        (jt, tt), (jc, tc) = _both(tgt), _both(cod)
        kw = dict(SMALL, stream=stream,
                  aux_variance_ratios=RATIOS if table else None)
        jcoder, tcoder = _coders(**kw)
        want = jcoder.encode(jt, jc, 23)
        got = tcoder.encode(tt, tc, 23)
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(want.counts))
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        for idx, cnt in ((np.asarray(want.indices), np.asarray(want.counts)),
                         (got.indices.numpy(), got.counts.numpy())):
            j_dec = np.asarray(jcoder.decode(jc, jnp.asarray(idx),
                                             jnp.asarray(cnt), 23))
            t_dec = tcoder.decode(tc, idx, cnt, 23).numpy()
            np.testing.assert_array_equal(_bits(t_dec), _bits(j_dec))
        assert torch.equal(got.sample.view(torch.int32), tcoder.decode(
            tc, got.indices, got.counts, 23).view(torch.int32))
        assert _bits(tcoder.codelength_nats(got).numpy()) == _bits(
            np.asarray(jcoder.codelength_nats(want)))

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_index_agreement_at_width(self, seed):
        """Full-size blocks (D = 1000, 4 chunks): counts equal; indices
        equal, or the first difference is a near tie of rec_tpu's weights
        (the fused XLA program rounds the per-dimension terms its own way),
        which is measured and reported."""
        rs = np.random.RandomState(seed)
        N, D = 2, 1000
        loc = (rs.randn(N, D) * 0.12).astype(np.float32)
        scale = np.exp(rs.randn(N, D) * 0.1 - 0.1).astype(np.float32)
        (jt, tt) = _both((loc, scale))
        (jc, tc) = _both((np.zeros((N, D), np.float32),
                          np.ones((N, D), np.float32)))
        jk, tk = _keys(seed, N)
        jcfg = jimp.ImportanceCoderConfig(coding_bits=12, max_partitions=8,
                                          candidate_chunk=1024)
        tcfg = timp.ImportanceCoderConfig(coding_bits=12, max_partitions=8,
                                          candidate_chunk=1024)
        want = jimp.encode_blocks(jcfg, jt, jc, jk)
        got = timp.encode_blocks(tcfg, tt, tc, tk)
        np.testing.assert_array_equal(got.count.numpy(),
                                      np.asarray(want.count))
        wi, gi = np.asarray(want.indices), got.indices.numpy()
        agree = float(np.mean(wi == gi))
        print(f"index agreement at D=1000: {agree}")
        assert agree >= 0.9
        for b in range(N):
            diff = np.nonzero(wi[b] != gi[b])[0]
            if len(diff):
                # The first difference must be a near tie in the port's own
                # weights of that step: measure its gap.
                t = int(diff[0])
                gap = _step_gap(tcfg, tt, tc, tk, b, t, wi[b, t], gi[b, t],
                                got.indices[b])
                print(f"block {b} step {t}: weight gap {gap}")
                assert gap < 1e-3

    def test_single_block_is_the_batch_at_one(self):
        tgt, cod = _prior_pair((3, 64), 4)
        (_, tt), (_, tc) = _both(tgt), _both(cod)
        cfg = timp.ImportanceCoderConfig(coding_bits=7, candidate_chunk=32)
        tk = _keys(5, 3)[1]
        out = timp.encode_blocks(cfg, tt, tc, tk)
        one = timp.encode_block(cfg, TG(tt.loc[1], tt.scale[1]),
                                TG(tc.loc[1], tc.scale[1]), tk[1])
        assert torch.equal(one.indices, out.indices[1])
        assert torch.equal(one.sample, out.sample[1])
        dec = timp.decode_block(cfg, TG(tc.loc[1], tc.scale[1]),
                                out.indices[1], out.count[1], tk[1])
        assert torch.equal(dec, out.sample[1])

    @pytest.mark.parametrize("elements", [32 * 96, 5 * 96])
    def test_memory_groups_do_not_change_the_choice(self, monkeypatch,
                                                    elements):
        """Proposals generated one (block, chunk) pair at a time, or five
        rows of a pair at a time (a 70-dim row is laid out in 96), give the
        indices of one group for everything."""
        tgt, cod = _prior_pair((3, 70), 6)
        (_, tt), (_, tc) = _both(tgt), _both(cod)
        cfg = timp.ImportanceCoderConfig(coding_bits=8, candidate_chunk=32,
                                         max_partitions=12)
        tk = _keys(7, 3)[1]
        whole = timp.encode_blocks(cfg, tt, tc, tk)
        monkeypatch.setitem(timp.GROUP_ELEMENTS, "cpu", elements)
        split = timp.encode_blocks(cfg, tt, tc, tk)
        assert torch.equal(whole.indices, split.indices)
        assert torch.equal(whole.sample, split.sample)


def _step_gap(cfg, tt, tc, tk, b, t, want_idx, got_idx, indices):
    """|w(want_idx) - w(got_idx)| of the port's log weights at step t of
    block b, its carry replayed through the port's indices before t (equal
    to rec_tpu's there)."""
    tg = TG(tt.loc[b:b + 1], tt.scale[b:b + 1])
    cd = TG(tc.loc[b:b + 1], tc.scale[b:b + 1])
    n = timp._counts(cfg, tg, cd).numpy()
    C, D = cfg.chunk_size, tg.loc.shape[-1]
    for s in range(t + 1):
        ratio = torch.from_numpy(timp.step_ratios(n, s))
        aux_var, aux_scale, std_t = timp._aux_step(tg, cd, ratio)
        skey = trng.step_key(tk[b:b + 1], s)
        if s == t:
            w = timp._chunk_weights(cfg, skey, std_t, math.inf,
                                    None).reshape(-1)
            return abs(float(w[int(want_idx)] - w[int(got_idx)]))
        i = indices[s].long().reshape(1)
        eps = trng.normal_stream_row(trng.fold_in(skey, i // C), i % C, C,
                                     D, stream=cfg.stream)
        tg, cd = timp._condition(tg, cd, aux_var, aux_scale * eps)


class TestReplay:
    @pytest.mark.parametrize("N,D,P", [(3, 64, 24), (9, 1000, 24),
                                       (4, 1000, 48), (2, 512, 24),
                                       (2, 128, 64), (2, 128, 200)])
    def test_einsum_is_a_sequential_fma_chain(self, N, D, P):
        """rec_tpu's replay contracts the partition axis with
        einsum("np,npd->nd"); jitted on XLA-CPU that is the port's chain
        acc = fma(sqrt_w[t], eps[t], acc), t = 0..P-1, then
        fma(scale, acc, loc), bit for bit, at these shapes."""
        rs = np.random.RandomState(N * D + P)
        (jc, tc) = _both(((rs.randn(N, D) * 0.5).astype(np.float32),
                          np.exp(rs.randn(N, D) * 0.3).astype(np.float32)))
        counts = rs.randint(1, P + 1, N).astype(np.int32)
        idx = rs.randint(0, 256, (N, P)).astype(np.int32)
        jk, tk = _keys(N + P, N)
        kw = dict(coding_bits=8, candidate_chunk=64, max_partitions=P)
        jcfg = jimp.ImportanceCoderConfig(**kw)
        tcfg = timp.ImportanceCoderConfig(**kw)
        want = np.asarray(jax.jit(
            lambda c, i, n, k: jimp.decode_blocks(jcfg, c, i, n, k))(
                jc, jnp.asarray(idx), jnp.asarray(counts), jk))
        got = timp.decode_blocks(tcfg, tc, torch.from_numpy(idx),
                                 torch.from_numpy(counts), tk).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))

    def test_replay_chain_is_fma(self):
        """The port's replay is the written chain: one fma per step."""
        tgt, cod = _prior_pair((2, 40), 8)
        (_, tt), (_, tc) = _both(tgt), _both(cod)
        cfg = timp.ImportanceCoderConfig(coding_bits=6, max_partitions=6)
        tk = _keys(9, 2)[1]
        out = timp.encode_blocks(cfg, tt, tc, tk)
        from rec_tpu_torch.coding.partition import schedule_table
        w, _ = schedule_table(out.count, 6, device="cpu")
        skeys = trng.step_key(tk[:, None, :], torch.arange(6)[None, :])
        idx = out.indices.long()
        eps = trng.normal_stream_row(trng.fold_in(skeys, idx // 64),
                                     idx % 64, 64, 40, stream="fmix")
        from rec_tpu_torch.ops.threefry_normal import sqrt_f32
        sw = sqrt_f32(w)
        acc = torch.zeros(2, 40)
        for t in range(6):
            acc = fma_f32_exact(sw[:, t, None], eps[:, t], acc)
        want = fma_f32_exact(tc.scale, acc, tc.loc)
        assert torch.equal(out.sample, want)


class TestSingleShot:
    def _pair(self, D=24, seed=0):
        rs = np.random.RandomState(seed)
        tgt = ((rs.randn(D) * 0.6).astype(np.float32),
               np.exp(rs.randn(D) * 0.2 - 0.5).astype(np.float32))
        cod = ((rs.randn(D) * 0.2).astype(np.float32),
               np.exp(rs.randn(D) * 0.1).astype(np.float32))
        return _both(tgt), _both(cod)

    @pytest.mark.parametrize("alpha", [math.inf, 1.0, 2.0, 7.5])
    def test_encode_and_decode_match_jax(self, alpha):
        """The index JAX picks (finite alpha with the same Gumbel draws),
        and both decodes bitwise."""
        (jt, tt), (jc, tc) = self._pair(seed=int(alpha) if alpha < 99 else 9)
        jkey = jrng.root_key(31)
        tkey = trng.root_key(31, "cpu")
        jidx, jsample = jimp.encode_gaussian_importance_sample(
            jt, jc, jkey, coding_bits=10, candidate_chunk=128, alpha=alpha)
        tidx, tsample = timp.encode_gaussian_importance_sample(
            tt, tc, tkey, coding_bits=10, candidate_chunk=128, alpha=alpha)
        assert int(tidx) == int(jidx)
        jdec = np.asarray(jimp.decode_gaussian_importance_sample(
            jc, jidx, jkey, coding_bits=10, candidate_chunk=128))
        tdec = timp.decode_gaussian_importance_sample(
            tc, tidx, tkey, coding_bits=10, candidate_chunk=128)
        np.testing.assert_array_equal(_bits(tdec.numpy()), _bits(jdec))
        assert torch.equal(tsample, tdec)
        np.testing.assert_array_equal(_bits(tsample.numpy()),
                                      _bits(np.asarray(jsample)))

    @pytest.mark.parametrize("alpha", [0.0, 0.5, 0.999])
    def test_alpha_below_one_raises(self, alpha):
        (_, tt), (_, tc) = self._pair()
        with pytest.raises(CodingError, match="alpha"):
            timp.encode_gaussian_importance_sample(
                tt, tc, trng.root_key(0, "cpu"), coding_bits=6, alpha=alpha)

    def test_custom_weighting_fn(self):
        """rec_tpu's SNIS-style scorer: the same index, a bitwise decode,
        and the energy pulls the sample toward (1.5, 1.5)."""
        jp = JG(jnp.zeros(2), jnp.ones(2))
        tp = TG(torch.zeros(2), torch.ones(2))
        jidx, _ = jimp.encode_gaussian_importance_sample(
            jp, jp, jax.random.PRNGKey(10), coding_bits=10,
            candidate_chunk=128,
            log_weighting_fn=lambda e: -jnp.sum(jnp.square(e - 1.5), -1))
        tidx, tsample = timp.encode_gaussian_importance_sample(
            tp, tp, trng.root_key(10, "cpu"), coding_bits=10,
            candidate_chunk=128,
            log_weighting_fn=lambda e: -xla_sum_f32(torch.square(e - 1.5)))
        assert int(tidx) == int(jidx)
        recon = timp.decode_gaussian_importance_sample(
            tp, tidx, trng.root_key(10, "cpu"), coding_bits=10,
            candidate_chunk=128)
        assert torch.equal(tsample, recon)
        assert float(torch.linalg.norm(tsample - 1.5)) < 1.5


class TestRoundTrip:
    """rec_tpu's TestGaussianCoderRoundTrip (tests/test_roundtrip.py:84-121)
    for the port."""

    def test_needle(self):
        d = 24
        tt = TG(torch.full((d,), 5.1 / d), torch.full((d,), 0.05))
        tc = TG(torch.zeros(d), torch.ones(d))
        gc = TGC(coding_bits=8, block_size=None, max_partitions=16,
                 candidate_chunk=64)
        coded = gc.encode(tt, tc, 42)
        assert torch.equal(coded.sample,
                           gc.decode(tc, coded.indices, coded.counts, 42))

    def test_multiblock_and_wrong_seed(self):
        rs = np.random.RandomState(3)
        tt = TG(torch.tensor(0.25 * rs.randn(4, 6, 3), dtype=torch.float32),
                torch.tensor(np.exp(0.2 * rs.randn(4, 6, 3) - 0.15),
                             dtype=torch.float32))
        tc = TG(torch.zeros(4, 6, 3), torch.ones(4, 6, 3))
        gc = TGC(coding_bits=8, block_size=16, max_partitions=16,
                 candidate_chunk=64)
        coded = gc.encode(tt, tc, 5)
        assert coded.indices.shape == (5, 16)
        dec = gc.decode(tc, coded.indices, coded.counts, 5)
        assert torch.equal(coded.sample, dec) and dec.shape == (4, 6, 3)
        assert float(gc.codelength_nats(coded)) > 0
        bad = gc.decode(tc, coded.indices, coded.counts, 6)
        assert not torch.allclose(bad, dec, atol=1e-3)

    def test_over_budget_clamps(self):
        tt = TG(torch.full((2, 30), 5.1), torch.full((2, 30), 1e-3))
        tc = TG(torch.zeros(2, 30), torch.ones(2, 30))
        gc = TGC(coding_bits=6, block_size=30, max_partitions=8)
        coded = gc.encode(tt, tc, 3)
        assert coded.counts.tolist() == [8, 8]
        assert gc.required_partitions(tt, tc, 3) > 8
        assert torch.equal(coded.sample,
                           gc.decode(tc, coded.indices, coded.counts, 3))

    def test_encode_batch_equals_per_image_encode(self):
        rs = np.random.RandomState(4)
        t = TG(torch.tensor(rs.randn(3, 6, 6, 8) * 0.5, dtype=torch.float32),
               torch.tensor(np.exp(rs.randn(3, 6, 6, 8) * 0.2),
                            dtype=torch.float32))
        c = TG(torch.zeros_like(t.loc), torch.ones_like(t.scale))
        gc = TGC(**SMALL)
        seeds = [7, 108, 2 ** 31 + 5]
        out = gc.encode_batch(t, c, seeds)
        for i, s in enumerate(seeds):
            one = gc.encode(TG(t.loc[i], t.scale[i]),
                            TG(c.loc[i], c.scale[i]), s)
            assert torch.equal(one.indices, out.indices[i])
            assert torch.equal(one.sample, out.sample[i])
        assert torch.equal(gc.decode_batch(c, out.indices, out.counts,
                                           seeds), out.sample)
        assert gc.max_index == 256
