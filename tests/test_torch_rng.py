"""rec_tpu_torch stream contract vs rec_tpu on JAX-CPU.

Integer streams (key words, fold_in chains, threefry bits, fmix bits, the
split permutation) must be bit-equal to ``jax.random`` / ``rec_tpu``.  The
bits -> normal map is checked on all 2^23 inputs it can receive.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import partition as jpart
from rec_tpu.coding import rng as jrng
from rec_tpu_torch.coding import partition as tpart
from rec_tpu_torch.coding import rng as trng
from rec_tpu_torch.ops import threefry_normal as ttn

torch.set_num_threads(2)

SEEDS = [0, 42, 1234 + 7919 * 23, 2 ** 31 - 1]


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    def ordered(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


class TestKeys:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_key_chain_bit_equal(self, seed):
        jroot, troot = jrng.root_key(seed), trng.root_key(seed, "cpu")
        np.testing.assert_array_equal(_kd(jroot), troot.numpy())
        np.testing.assert_array_equal(_kd(jrng.split_key(jroot)),
                                      trng.split_key(troot).numpy())
        for b in (0, 1, 8):
            jb, tb = jrng.block_key(jroot, b), trng.block_key(troot, b)
            np.testing.assert_array_equal(_kd(jb), tb.numpy())
            for t in (0, 5, 23):
                js, ts = jrng.step_key(jb, t), trng.step_key(tb, t)
                np.testing.assert_array_equal(_kd(js), ts.numpy())
                np.testing.assert_array_equal(_kd(jrng.pool_key(js)),
                                              trng.pool_key(ts).numpy())
                for h in (jrng.FNV_OFFSET, np.uint32(0xDEADBEEF)):
                    np.testing.assert_array_equal(
                        _kd(jrng.beam_stream_key(js, jnp.uint32(h))),
                        trng.beam_stream_key(ts, int(h)).numpy())

    def test_vectorised_fold_in_and_split(self):
        jroot, troot = jrng.root_key(9), trng.root_key(9, "cpu")
        blocks = np.arange(37)
        want = np.stack([_kd(jrng.block_key(jroot, int(b))) for b in blocks])
        got = trng.block_key(troot, torch.from_numpy(blocks))
        np.testing.assert_array_equal(want, got.numpy())
        jk = jax.random.split(jrng.split_key(jroot), 2)
        tk = trng.split(trng.split_key(troot))
        np.testing.assert_array_equal(_kd(jk), torch.stack(tk).numpy())

    def test_fnv_step(self):
        h = np.array([jrng.FNV_OFFSET, 0, 0xFFFFFFFF, 0x12345678], np.uint32)
        idx = np.array([0, 35, 7, 120], np.int32)
        want = np.asarray(jrng.fnv_step(jnp.asarray(h), jnp.asarray(idx)))
        got = trng.fnv_step(torch.from_numpy(h.astype(np.int64)),
                            torch.from_numpy(idx.astype(np.int64)))
        np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


class TestBits:
    @pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
    def test_threefry_random_bits(self, seed):
        key = jax.random.PRNGKey(seed)
        kd = _kd(key)
        for n in (8, 1000, 1001):
            want = np.asarray(jax.random.bits(key, (n,), dtype=jnp.uint32))
            got = ttn.random_bits(int(kd[0]), int(kd[1]),
                                  torch.arange(n, dtype=torch.int64))
            np.testing.assert_array_equal(want.astype(np.int64), got.numpy())

    def test_fmix_bits(self):
        ctr = np.concatenate([np.arange(300), [2 ** 31, 2 ** 32 - 1]])
        for k1, k2 in ((0, 0), (0xDEADBEEF, 7), (2 ** 32 - 1, 2 ** 31)):
            want = np.asarray(jrng.fmix_bits(
                jnp.uint32(k1), jnp.uint32(k2), jnp.asarray(ctr, jnp.uint32)))
            got = trng.fmix_bits(k1, k2, torch.from_numpy(ctr))
            np.testing.assert_array_equal(want.astype(np.int64), got.numpy())

    @pytest.mark.parametrize("stream", ["fmix", "threefry"])
    def test_normal_stream_rows(self, stream):
        """Whole streams and directly addressed rows equal rec_tpu's."""
        key = jrng.block_key(jrng.root_key(3), 1)
        tkey = trng.block_key(trng.root_key(3, "cpu"), 1)
        S, D = 7, 130
        want = np.asarray(jrng.normal_stream(key, (S, D), stream=stream))
        got = trng.normal_stream(tkey, (S, D), stream=stream).numpy()
        assert _ulp(want, got).max() == 0
        for row in (0, 3, 6):
            r = trng.normal_stream_row(tkey, row, S, D, stream=stream)
            np.testing.assert_array_equal(r.numpy(), got[row])


class TestNormalMap:
    def test_exhaustive_against_jax(self):
        """All 2^23 inputs of the bits -> normal map (only bits >> 9 reach
        it) against ``rng._bits_to_normal_f32`` on XLA-CPU.

        The port copies XLA-CPU's log1p, log and erfinv op by op, so every
        output is bitwise equal (0 ulp)."""
        mismatches, worst = 0, 0
        to_normal = jax.jit(jrng._bits_to_normal_f32)
        for lo in range(0, 2 ** 23, 2 ** 21):
            bits = np.arange(lo, lo + 2 ** 21, dtype=np.uint32) << 9
            want = np.asarray(to_normal(jnp.asarray(bits)))
            got = trng._bits_to_normal_f32(
                torch.from_numpy(bits.astype(np.int64))).numpy()
            u = _ulp(want, got)
            mismatches += int(np.count_nonzero(u))
            worst = max(worst, int(u.max()))
        assert worst == 0, worst
        assert mismatches == 0, mismatches

    def test_statistics(self):
        bits = trng.fmix_bits(1, 2, torch.arange(200_000, dtype=torch.int64))
        x = trng._bits_to_normal_f32(bits).numpy()
        assert abs(x.mean()) < 0.01 and abs(x.std() - 1.0) < 0.01

    def test_sqrt_correctly_rounded(self):
        rs = np.random.RandomState(0)
        x = np.concatenate([
            np.exp(rs.uniform(-20, 20, 100_000)), [0.0, 1.0, 4.0, 5.0, 2.0],
            np.float32(rs.uniform(5, 17, 100_000))]).astype(np.float32)
        got = ttn.sqrt_f32(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.sqrt(x))


def _round_f32(fr):
    """Correctly rounded float32 of a Fraction (ties to even)."""
    from fractions import Fraction

    r = np.float32(float(fr))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - fr) for c in cands)
    tied = [c for c in cands if abs(Fraction(float(c)) - fr) == best]
    return min(tied, key=lambda c: int(np.float32(c).view(np.int32)) & 1)


class TestExactFma:
    def test_correctly_rounded(self):
        """fma_f32_exact (the replay's accumulation step) against exact
        rational arithmetic, on random operands and on sums that cancel
        to near the product (where a plain float64 sum rounds twice)."""
        from fractions import Fraction

        rs = np.random.RandomState(0)
        n = 3000
        a = (rs.randn(n) * np.exp2(rs.randint(-8, 8, n))).astype(np.float32)
        b = (rs.randn(n) * np.exp2(rs.randint(-8, 8, n))).astype(np.float32)
        c = (rs.randn(n) * np.exp2(rs.randint(-30, 8, n))).astype(np.float32)
        near = -(a.astype(np.float64) * b).astype(np.float32)
        c[: n // 2] = near[: n // 2] * (1 + rs.randn(n // 2) * 2.0 ** -20)
        got = ttn.fma_f32_exact(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(c)).numpy()
        want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                    + Fraction(float(z)))
                         for x, y, z in zip(a, b, c)], np.float32)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


class TestSplitPermutation:
    @pytest.mark.parametrize("n", [1000, 8192, 9000, 37])
    def test_matches_jax(self, n):
        for seed in (0, 1234):
            plan = jpart.plan_split(n, 1000)
            want = np.asarray(jpart.split_permutation(jrng.root_key(seed),
                                                      plan))
            got = tpart.split_permutation(trng.root_key(seed, "cpu"),
                                          tpart.plan_split(n, 1000))
            np.testing.assert_array_equal(want, got.numpy())
