"""rec_tpu_torch's rejection coder vs rec_tpu on JAX-CPU: XLA-CPU's
float32 exp, the mass estimate, the float64 r/p* buffers, the acceptance
rounds with their spillover, the sampler's update / code length / max-KL
refusal, ``RejectionCoder`` in both modes and the pseudo-sample generator,
at small sizes (D = 16-64, buffers of 1,000).  Everything but
``pseudo_ratios``' matmul is held bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import gauss as jgauss
from rec_tpu.coding import rejection as jrej
from rec_tpu.coding import sample_generator as jgen
from rec_tpu.coding.rejection_coder import RejectionCoder as JCoder
from rec_tpu.coding.utils import CodingError as JCodingError
from rec_tpu_torch.coding import gauss as tgauss
from rec_tpu_torch.coding import rejection as trej
from rec_tpu_torch.coding import rng as trng
from rec_tpu_torch.coding import sample_generator as tgen
from rec_tpu_torch.coding.rejection_coder import RejectionCoder as TCoder
from rec_tpu_torch.coding.utils import CodingError
from rec_tpu_torch.ops.threefry_normal import bits_to_erfinv, exp_f32

torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def _pair(D, seed, spread=0.3, sharp=0.3):
    """A (target, coder) pair of D dims as numpy (loc, scale) arrays."""
    rs = np.random.RandomState(seed)
    tl = (spread * rs.randn(D)).astype(np.float32)
    ts = np.exp(0.2 * rs.randn(D) - sharp).astype(np.float32)
    cl = (0.1 * rs.randn(D)).astype(np.float32)
    cs = np.exp(0.1 * rs.randn(D)).astype(np.float32)
    return (tl, ts), (cl, cs)


def J(p):
    return jgauss.GaussianParams(jnp.asarray(p[0]), jnp.asarray(p[1]))


def T(p):
    return tgauss.GaussianParams(torch.from_numpy(p[0]),
                                 torch.from_numpy(p[1]))


def _key(seed):
    return trng.root_key(seed, device="cpu")


def _standard(D):
    return np.zeros(D, np.float32), np.ones(D, np.float32)


SMALL = dict(sample_buffer_size=1000, r_buffer_size=1000)


class TestXlaExp:
    def test_exp_matches_xla_bitwise(self):
        """XLA-CPU's float32 exp (clamps, Cephes polynomial, fused
        multiply-adds, flushed subnormals) on 2^24 inputs over the
        acceptance test's range [-90, 90], and its edges."""
        rs = np.random.RandomState(0)
        x = rs.uniform(-90.0, 90.0, 1 << 24).astype(np.float32)
        edges = np.float32([np.nan, np.inf, -np.inf, 0.0, -0.0, -87.8,
                            88.8, -87.33, -88.0, 88.72, 88.73, 1e-30,
                            -1e-30, 1e-45, -103.0])
        x = np.concatenate([x, edges])
        want = np.asarray(jax.jit(jnp.exp)(x))
        got = exp_f32(torch.from_numpy(x)).numpy()
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])

    def test_torch_exp_differs(self):
        """Why the emulation exists: torch's float32 exp is not XLA's."""
        x = np.random.RandomState(1).uniform(-30, 10, 1 << 16).astype(
            np.float32)
        want = _bits(jax.jit(jnp.exp)(x))
        assert np.sum(_bits(torch.exp(torch.from_numpy(x))) != want) > 0


class TestDraws:
    def test_erfinv_table_is_the_map(self):
        bits = torch.randint(0, 1 << 32, (1 << 16,), dtype=torch.int64,
                             generator=torch.Generator().manual_seed(0))
        bits[:2] = torch.tensor([0, (1 << 32) - 1])
        table = trng.erfinv_table(torch.device("cpu"))
        assert torch.equal(table[trng.table_index(bits)],
                           bits_to_erfinv(bits))

    @pytest.mark.parametrize("minval", [0.0, float(np.finfo(np.float32).tiny)])
    def test_uniform_matches_jax(self, minval):
        got = trng.uniform(_key(5), 4096, minval).numpy()
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (4096,),
                                             minval=minval))
        np.testing.assert_array_equal(_bits(got), _bits(want))

    @pytest.mark.parametrize("shape,lo,hi", [((64,), 0, 50),
                                             ((7, 300), 0, 8),
                                             ((1000,), 3, 1000003)])
    def test_randint_matches_jax(self, shape, lo, hi):
        got = tgen.randint(_key(9), shape, lo, hi).numpy()
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(9), shape,
                                             lo, hi))
        np.testing.assert_array_equal(got, want)

    def test_split_three_is_fold_in(self):
        want = np.asarray(jax.random.key_data(jax.random.split(
            jax.random.PRNGKey(4), 3)))
        got = np.stack([trng.fold_in(_key(4), i).numpy() for i in range(3)])
        np.testing.assert_array_equal(got, want)


class TestEstimateMass:
    @pytest.mark.parametrize("D,n,o", [(1, 10, 10), (16, 100, 100),
                                       (24, 100, 100), (40, 100, 100),
                                       (64, 100, 100), (1000, 10, 10)])
    def test_bitwise(self, D, n, o):
        t, c = _pair(D, D)
        want = jrej.estimate_mass(J(t), J(c), jax.random.PRNGKey(7), n, o)
        got = trej.estimate_mass(T(t), T(c), _key(7), n, o)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def _jax_mass(t, c, key_seed, n=100, o=100):
    lr, tm, pm = jrej.estimate_mass(J(t), J(c), jax.random.PRNGKey(key_seed),
                                    n, o)
    return np.asarray(lr), np.asarray(tm), np.asarray(pm)


class TestRPstarBuffers:
    @pytest.mark.parametrize("n_samples,buffer", [(10, 10000), (2, 100000)])
    def test_needle_bitwise_and_fast_matches_naive(self, n_samples, buffer):
        """rec_tpu's needle target: both recursions give rec_tpu's float64
        bits, and the fast path tracks the defining recursion."""
        t = (np.float32([3.0]), np.float32([0.001]))
        mass = _jax_mass(t, _standard(1), 0, n_samples, 10)
        for name in ("r_pstar_buffers", "r_pstar_naive"):
            want = getattr(jrej, name)(*mass, buffer)
            got = getattr(trej, name)(*mass, buffer)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g, w)
        r_f, ps_f = trej.r_pstar_buffers(*mass, buffer)
        r_n, ps_n = trej.r_pstar_naive(*mass, buffer)
        np.testing.assert_allclose(r_f, r_n, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ps_f, ps_n, rtol=1e-5, atol=1e-5)

    def test_smooth_target_from_the_ports_estimate(self):
        t, c = _pair(40, 3)
        mass = [a.numpy() for a in trej.estimate_mass(T(t), T(c), _key(3))]
        want = jrej.r_pstar_buffers(*_jax_mass(t, c, 3), 20000)
        got = trej.r_pstar_buffers(*mass, 20000)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        r_n, ps_n = trej.r_pstar_naive(*mass, 20000)
        np.testing.assert_allclose(got[0], r_n, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[1], ps_n, rtol=1e-4, atol=1e-4)


class TestRejectionSample:
    @pytest.mark.parametrize("D,seed", [(16, 0), (16, 3), (40, 0), (40, 5),
                                        (64, 0), (64, 4)])
    def test_index_and_sample_bitwise(self, D, seed):
        """The same standardized target, buffers and key give the same
        index, found flag and sample bits; (64, 0) accepts in the
        spillover (index past the 5,000-entry r buffer)."""
        t, _ = _pair(D, 100 + D, spread=0.15, sharp=0.3)
        cfg = dict(sample_buffer_size=1000, r_buffer_size=5000)
        rb, pb = jrej.r_pstar_buffers(*_jax_mass(t, _standard(D), 0), 5000)
        want = jrej.rejection_sample(
            jrej.RejectionSamplerConfig(**cfg), J(t),
            jax.random.PRNGKey(seed), jnp.asarray(rb, jnp.float32),
            jnp.asarray(pb, jnp.float32))
        tcfg = trej.RejectionSamplerConfig(**cfg)
        got = trej.rejection_sample(tcfg, T(t), _key(seed),
                                    torch.from_numpy(rb).float(),
                                    torch.from_numpy(pb).float())
        assert got.index == int(want.index)
        assert got.found == bool(want.found)
        np.testing.assert_array_equal(_bits(got.sample.numpy()),
                                      _bits(want.sample))
        if (D, seed) == (64, 0):
            assert got.index >= 5000
        # Decode in both directions.
        jcfg = jrej.RejectionSamplerConfig(**cfg)
        np.testing.assert_array_equal(
            _bits(trej.decode_rejection_sample(tcfg, _key(seed),
                                               int(want.index), D).numpy()),
            _bits(jrej.decode_rejection_sample(
                jcfg, jax.random.PRNGKey(seed), got.index, D)))


class TestRejectionSampler:
    def test_update_and_codelength_bitwise(self):
        t, c = _pair(40, 11)
        js = jrej.RejectionSampler(jrej.RejectionSamplerConfig(**SMALL))
        ts = trej.RejectionSampler(trej.RejectionSamplerConfig(**SMALL))
        for k in (1, 2):
            js.update(J(t), J(c), jax.random.PRNGKey(k))
            ts.update(T(t), T(c), _key(k))
        np.testing.assert_array_equal(ts.acceptance_probabilities,
                                      js.acceptance_probabilities)
        assert ts.spillover_probability == js.spillover_probability
        assert ts.spillover_acceptance == js.spillover_acceptance
        for index in (0, 17, 999, 1000, 1500):
            assert ts.get_codelength(index) == js.get_codelength(index)

    def test_coded_sample_and_decode(self):
        t, c = _pair(16, 12, spread=0.2, sharp=0.1)
        js = jrej.RejectionSampler(jrej.RejectionSamplerConfig(**SMALL))
        ts = trej.RejectionSampler(trej.RejectionSamplerConfig(**SMALL))
        ji, jsample = js.coded_sample(J(t), J(c), jax.random.PRNGKey(42))
        ti, tsample = ts.coded_sample(T(t), T(c), _key(42))
        assert ti == ji
        np.testing.assert_array_equal(_bits(tsample.numpy()), _bits(jsample))
        np.testing.assert_array_equal(
            _bits(ts.decode_sample(T(c), ti, _key(42)).numpy()),
            _bits(jsample))

    def test_kl_too_high_raises(self):
        t = (np.full(16, 4.0, np.float32), np.full(16, 0.01, np.float32))
        with pytest.raises(JCodingError):
            jrej.RejectionSampler().coded_sample(J(t), J(_standard(16)),
                                                 jax.random.PRNGKey(0))
        with pytest.raises(CodingError, match="too high"):
            trej.RejectionSampler().coded_sample(T(t), T(_standard(16)),
                                                 _key(0))

    def test_codelength_needs_update(self):
        with pytest.raises(CodingError, match="not initialized"):
            trej.RejectionSampler().get_codelength(0)


class TestRejectionCoder:
    @pytest.mark.parametrize("D", [16, 40])
    def test_encode_decode_bitwise_both_ways(self, D):
        t, c = _pair(D, D, spread=0.6, sharp=0.8)
        cfg = dict(sample_buffer_size=1000, r_buffer_size=1000)
        jc = JCoder(sampler_config=jrej.RejectionSamplerConfig(**cfg))
        tc = TCoder(sampler_config=trej.RejectionSamplerConfig(**cfg))
        ji, jsample = jc.encode_block(J(t), J(c), seed=3)
        ti, tsample = tc.encode_block(T(t), T(c), seed=3)
        assert len(ti) > 1 and ti == ji
        np.testing.assert_array_equal(_bits(tsample.numpy()), _bits(jsample))
        np.testing.assert_array_equal(
            _bits(tc.decode_block(T(c), ji, seed=3).numpy()), _bits(jsample))
        np.testing.assert_array_equal(
            _bits(jc.decode_block(J(c), ti, seed=3)), _bits(tsample.numpy()))
        # Update mode: the same acceptance statistics, then code lengths.
        jc.encode_block(J(t), J(c), seed=5, update_sampler=True)
        tc.encode_block(T(t), T(c), seed=5, update_sampler=True)
        np.testing.assert_array_equal(tc.sampler.acceptance_probabilities,
                                      jc.sampler.acceptance_probabilities)
        assert tc.sampler.average_count == jc.sampler.average_count
        assert tc.get_codelength(ti) == jc.get_codelength(ji)

    def test_encode_steps_are_the_block_chain(self):
        t, c = _pair(16, 16, spread=0.6, sharp=0.8)
        cfg = dict(sample_buffer_size=1000, r_buffer_size=1000)
        jc = JCoder(sampler_config=jrej.RejectionSamplerConfig(**cfg))
        tc = TCoder(sampler_config=trej.RejectionSamplerConfig(**cfg))
        ji, jsample = jc.encode_block(J(t), J(c), seed=3)
        steps = list(tc.encode_steps(T(t), T(c), seed=3))
        assert len(steps) == tc.num_partitions(T(t), T(c)) > 1
        assert [index for index, _, _ in steps] == ji
        np.testing.assert_array_equal(_bits(steps[-1][2].loc.numpy()),
                                      _bits(jsample))

    def test_learned_ratio_table_overflow_raises(self):
        t, c = _pair(16, 2, spread=0.6, sharp=0.8)
        tc = TCoder(sampler_config=trej.RejectionSamplerConfig(**SMALL),
                    aux_variance_ratios=(0.5,))
        jc = JCoder(sampler_config=jrej.RejectionSamplerConfig(**SMALL),
                    aux_variance_ratios=(0.5,))
        assert tc.num_partitions(T(t), T(c)) > 1
        with pytest.raises(JCodingError):
            jc.encode_block(J(t), J(c), seed=1)
        with pytest.raises(CodingError, match="learned table"):
            tc.encode_block(T(t), T(c), seed=1)

    def test_learned_ratios_bitwise(self):
        t, c = _pair(16, 6, spread=0.3, sharp=0.4)
        table = tuple(float(r) for r in np.linspace(0.3, 1.0, 12)[::-1])
        jc = JCoder(sampler_config=jrej.RejectionSamplerConfig(**SMALL),
                    aux_variance_ratios=table)
        tc = TCoder(sampler_config=trej.RejectionSamplerConfig(**SMALL),
                    aux_variance_ratios=table)
        ji, jsample = jc.encode_block(J(t), J(c), seed=8)
        ti, tsample = tc.encode_block(T(t), T(c), seed=8)
        assert ti == ji
        np.testing.assert_array_equal(_bits(tsample.numpy()), _bits(jsample))


class TestPseudoSampleGenerator:
    CFG = dict(buffer_size=64, n_true_samples=8, n_groups=6)

    def _args(self):
        t = (np.full(10, 0.1, np.float32), np.full(10, 0.1, np.float32))
        return t, _standard(10)

    @pytest.mark.parametrize("index", [0, 5, 63])
    def test_pseudo_sample_exact(self, index):
        _, c = self._args()
        want = jgen.pseudo_sample(jgen.PseudoSampleGeneratorConfig(
            **self.CFG), J(c), jax.random.PRNGKey(420), index)
        got = tgen.pseudo_sample(tgen.PseudoSampleGeneratorConfig(
            **self.CFG), T(c), _key(420), index)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

    def test_pseudo_ratios_to_float_tolerance(self):
        """The one-hot matmul sums in another order than XLA's dot: held
        to rtol 1e-5, atol 1e-4 (measured 6.1e-5 absolute; printed)."""
        t, c = self._args()
        want = np.asarray(jgen.pseudo_ratios(jgen.PseudoSampleGeneratorConfig(
            **self.CFG), J(t), J(c), jax.random.PRNGKey(420)))
        got = tgen.pseudo_ratios(tgen.PseudoSampleGeneratorConfig(
            **self.CFG), T(t), T(c), _key(420)).numpy()
        print("pseudo_ratios max |port - rec_tpu|:",
              float(np.max(np.abs(got - want))))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        # The ratio of a materialized sample is its log-ratio sum.
        cfg = tgen.PseudoSampleGeneratorConfig(**self.CFG)
        for i in (0, 5, 63):
            s = tgen.pseudo_sample(cfg, T(c), _key(420), i)
            direct = torch.sum(tgauss.log_density_ratio(s, T(t), T(c)))
            np.testing.assert_allclose(float(got[i]), float(direct),
                                       rtol=1e-4, atol=1e-4)
