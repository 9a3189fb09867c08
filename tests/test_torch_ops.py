"""rec_tpu_torch.ops vs rec_tpu.ops on JAX-CPU: candidate scoring (B2), the
beam-search wrapper's block-axis chunking and launch planning (B1), and the
one nvcc build path.  The CUDA kernels themselves run only on the card, in
tests/test_torch_{mega_beam,beam_score}_card.py."""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import GaussianParams as JG
from rec_tpu.ops import beam_score as jscore
from rec_tpu.ops import score_candidates as j_score_candidates
from rec_tpu_torch.coding import GaussianParams as TG
from rec_tpu_torch.coding import rng as trng
from rec_tpu_torch.coding.gauss import quadratic_coeffs
from rec_tpu_torch.ops import _build
from rec_tpu_torch.ops import beam_score as tscore
from rec_tpu_torch.ops import mega_beam as tmb
from rec_tpu_torch.ops import score_candidates as t_score_candidates
from rec_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _ulp(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def _gauss(rs, D, loc, log_scale):
    loc = (rs.randn(D) * loc).astype(np.float32)
    scale = np.exp(rs.randn(D) * log_scale).astype(np.float32)
    return (JG(jnp.asarray(loc), jnp.asarray(scale)),
            TG(torch.from_numpy(loc), torch.from_numpy(scale)))


class TestScoreCandidates:
    @pytest.mark.parametrize("B,S,D", [(4, 7, 128), (20, 36, 1000),
                                       (3, 5, 33)])
    def test_matches_jax(self, B, S, D):
        """The port's entry point on CPU tensors against rec_tpu's jnp
        path: rtol 1e-5 (the sums over D are taken in another order)."""
        rs = np.random.RandomState(D)
        (jn, tn), (jd, td) = (_gauss(rs, D, 0.5, 0.3),
                              _gauss(rs, D, 0.2, 0.1))
        x = rs.randn(B, S, D).astype(np.float32)
        want = np.asarray(j_score_candidates(jnp.asarray(x), jn, jd,
                                             use_pallas=False))
        got = t_score_candidates(torch.from_numpy(x), tn, td)
        assert got.shape == (B, S)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)

    def test_quadratic_coeffs_match_jax(self):
        """a and b elementwise within 1 ulp; c_sum (a sum over D) within
        rtol 1e-6."""
        rs = np.random.RandomState(1)
        (jn, tn), (jd, td) = (_gauss(rs, 300, 0.5, 0.3),
                              _gauss(rs, 300, 0.2, 0.1))
        ja, jb, jc = jscore._quadratic_coeffs(jn, jd)
        ta, tb, tc = quadratic_coeffs(tn, td)
        assert _ulp(np.asarray(ja), ta.numpy()).max() <= 1
        assert _ulp(np.asarray(jb), tb.numpy()).max() <= 1
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-6)

    def test_cpu_tensors_take_the_plain_version(self):
        rs = np.random.RandomState(2)
        x = torch.tensor(rs.randn(6, 40), dtype=torch.float32)
        a, b = torch.randn(40), torch.randn(40)
        c = torch.tensor(0.5)
        before = profiling.counter("beam_score.launches")
        got = tscore.score_rows(x, a, b, c)
        assert profiling.counter("beam_score.launches") == before
        assert torch.equal(got, tscore.score_candidates_ref(x, a, b, c))

    def test_kernel_rejects_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA device"):
            tscore.launch_kernel(torch.zeros(2, 4), torch.zeros(4),
                                 torch.zeros(4), torch.zeros(()))


class TestChunking:
    def _inputs(self, N=7, D=48, seed=0):
        rs = np.random.RandomState(seed)
        t = TG(torch.tensor(rs.randn(N, D) * 0.5, dtype=torch.float32),
               torch.tensor(np.exp(rs.randn(N, D) * 0.2),
                            dtype=torch.float32))
        c = TG(torch.zeros(N, D), torch.ones(N, D))
        keys = trng.block_key(trng.root_key(3, "cpu"), torch.arange(N))
        return t, c, keys

    @pytest.mark.parametrize("blocks_per_call", [1, 2, 3])
    def test_chunked_equals_unchunked(self, monkeypatch, blocks_per_call):
        """A schedule budget of a few blocks forces equal chunks of the
        block axis (with padding blocks); indices and counts are bitwise
        those of one call."""
        t, c, keys = self._inputs()
        kw = dict(kl_per_partition=3.0, n_beams=3, n_samples=8,
                  max_partitions=6, stream="fmix")
        whole = tmb.mega_encode_blocks(t, c, keys, **kw)
        per_block = 3 * 6 * 128 * 4
        calls = []
        real = tmb._encode_call
        monkeypatch.setattr(tmb, "_SCHED_LIMIT_BYTES",
                            per_block * blocks_per_call)
        monkeypatch.setattr(tmb, "_encode_call", lambda *a, **k: (
            calls.append(a[0].loc.shape[0]) or real(*a, **k)))
        chunked = tmb.mega_encode_blocks(t, c, keys, **kw)
        assert calls == [blocks_per_call] * -(-7 // blocks_per_call)
        assert torch.equal(whole[0], chunked[0])
        assert torch.equal(whole[1], chunked[1])


def _score_units(n_live, t, B, S):
    """Units of the kernel's score phase at step t: (live block, beam,
    GROUP candidates); at t = 0 only beam 0 scores."""
    return n_live * (1 if t == 0 else B) * -(-S // tmb.GROUP)


def _warp_rows(gw, n_warps, n_live, t, B, S):
    """The (live block index, beam, candidate) rows that global warp ``gw``
    (warp w of CTA c is w * n_ctas + c: across CTAs first) scores at step
    t, as ``score_phase`` in csrc/mega_beam.cu deals them."""
    n_beam = 1 if t == 0 else B
    n_grp = -(-S // tmb.GROUP)
    rows = []
    for u in range(gw, _score_units(n_live, t, B, S), n_warps):
        li, rem = divmod(u, n_beam * n_grp)
        b, g = divmod(rem, n_grp)
        rows += [(li, b, s) for s in range(g * tmb.GROUP,
                                           min(S, (g + 1) * tmb.GROUP))]
    return rows


class _FakeLibrary:
    """Stands in for the built library's occupancy query."""

    def __init__(self, threads, group):
        self.values = (132, 2, threads, group, 1)

    def mega_beam_occupancy(self, stream_kind, *outs):
        for out, v in zip(outs, self.values):
            out._obj.value = v
        return 0


class TestLaunchPlan:
    """The beam-search kernel's launch plan, which is plain Python: the
    cooperative grid, the block order by count, the score phase's rows per
    warp and the scratch."""

    @pytest.mark.parametrize("sms,per_sm", [(132, 2), (132, 4), (1, 1)])
    def test_grid_is_every_resident_cta(self, sms, per_sm):
        assert tmb.grid_ctas(sms, per_sm) == sms * per_sm

    @pytest.mark.parametrize("threads,group,ok", [
        (tmb.THREADS, tmb.GROUP, True), (tmb.THREADS, tmb.GROUP + 2, False),
        (2 * tmb.THREADS, tmb.GROUP, False)])
    def test_grid_checks_the_library_geometry(self, monkeypatch, threads,
                                              group, ok):
        """The grid comes from the library's occupancy query, whose threads
        per CTA and candidate group must be those the wrapper plans."""
        monkeypatch.setattr(tmb, "_load_kernel",
                            lambda: _FakeLibrary(threads, group))
        tmb.grid.cache_clear()
        try:
            if ok:
                assert tmb.grid(-1, "fmix") == (264, tmb.THREADS)
            else:
                with pytest.raises(RuntimeError, match="wrapper plans"):
                    tmb.grid(-1, "fmix")
        finally:
            tmb.grid.cache_clear()

    @pytest.mark.parametrize("sms,per_sm,coop", [(132, 0, True),
                                                 (0, 2, True),
                                                 (132, 2, False)])
    def test_grid_raises_when_the_kernel_cannot_launch(self, sms, per_sm,
                                                       coop):
        with pytest.raises(RuntimeError, match="mega_beam"):
            tmb.grid_ctas(sms, per_sm, coop)

    def test_live_plan(self):
        counts = torch.tensor([3, 0, 7, 3, 9, 1], dtype=torch.int32)
        order, live = tmb.live_plan(counts, P=8)
        assert order.dtype == live.dtype == torch.int32
        # Longest first, ties by block; a count past P runs P steps.
        assert order.tolist() == [4, 2, 0, 3, 5, 1]
        assert live.tolist() == [5, 4, 4, 2, 2, 2, 2, 1]
        n = torch.clamp(counts, max=8)
        for t in range(8):
            first = order[:live[t]].long()
            assert bool((n[first] > t).all())
            assert bool((n[order[live[t]:].long()] <= t).all())

    @pytest.mark.parametrize("N", [1, 9, 72, 133])
    @pytest.mark.parametrize("t", [0, 5])
    @pytest.mark.parametrize("n_warps", [37, 2112])
    def test_rows_cover_each_live_row_once(self, N, t, n_warps):
        """Every (live block, beam, candidate) row of a step is scored by
        exactly one warp: one beam at t = 0, B beams after."""
        B, S = 20, 36
        n_live = max(1, N - 3 * t)
        seen = []
        for gw in range(n_warps):
            seen += _warp_rows(gw, n_warps, n_live, t, B, S)
        beams = 1 if t == 0 else B
        assert len(seen) == n_live * beams * S
        assert set(seen) == {(li, b, s) for li in range(n_live)
                             for b in range(beams) for s in range(S)}

    def test_rows_spread_over_the_grid(self):
        """Consecutive units go to different CTAs: at N=9 every warp of the
        grid's first row of CTAs has work and no warp has two units."""
        n_ctas, B, S = 264, 20, 36
        n_warps = n_ctas * tmb.THREADS // 32
        units = _score_units(9, 1, B, S)
        assert units == 9 * B * -(-S // tmb.GROUP)
        busy = {gw for gw in range(n_warps)
                if _warp_rows(gw, n_warps, 9, 1, B, S)}
        assert len(busy) == units
        ctas = {gw % n_ctas for gw in busy}   # warp w of CTA c: w*n + c
        assert ctas == set(range(n_ctas))

    def test_scratch_shapes(self):
        shapes = tmb.scratch_shapes(N=72, B=20, S=36, P=24, D=1000)
        assert list(shapes) == ["beams", "hist", "hashes", "skeys", "scores",
                                "sel"]
        assert shapes["beams"] == ((72, 2, 20, 1000), torch.float32)
        assert shapes["hist"] == ((72, 2, 20, 24), torch.int32)
        assert shapes["hashes"] == ((72, 2, 20), torch.int32)
        assert shapes["skeys"] == ((72, 2, 20, 2), torch.int32)
        assert shapes["scores"] == ((72, 720), torch.float32)
        assert shapes["sel"] == ((72, 2, 20), torch.int32)

    def test_kernel_rejects_cpu_tensors(self):
        z = torch.zeros(2, 3, 8)
        with pytest.raises(ValueError, match="CUDA device"):
            tmb.launch_kernel(torch.ones(2, dtype=torch.int32),
                              torch.zeros(2, 2, dtype=torch.int64), z, z, z,
                              n_beams=4, n_samples=8, stream="fmix")


class TestBuild:
    def _fake_nvcc(self, tmp_path, body):
        path = tmp_path / "nvcc"
        path.write_text("#!/bin/sh\n" + body + "\n")
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
        return str(path)

    def _fake_tree(self, monkeypatch, tmp_path, nvcc):
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for name in ("one", "two"):
            (csrc / f"{name}.cu").write_text("// kernel\n")
        monkeypatch.setattr(_build, "CSRC", str(csrc))
        monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
        monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)

    def test_builds_each_source_once(self, monkeypatch, tmp_path):
        """One library per source; a library newer than its source is
        reused without running nvcc."""
        log = tmp_path / "log"
        nvcc = self._fake_nvcc(
            tmp_path, f'echo "$@" >> {log}\nfor a; do '
                      f'[ "$prev" = "-o" ] && touch "$a"; prev=$a; done')
        self._fake_tree(monkeypatch, tmp_path, nvcc)
        libs = _build.build_all(["one", "two"])
        assert sorted(os.path.basename(p) for p in libs.values()) == [
            "libone.so", "libtwo.so"]
        assert all(os.path.exists(p) for p in libs.values())
        lines = log.read_text().splitlines()
        assert len(lines) == 2 and all("sm_90a" in ln for ln in lines)
        assert _build.build_kernel("one") == libs["one"]
        assert len(log.read_text().splitlines()) == 2

    def test_parse_ptxas(self):
        """Registers, shared memory and spills per kernel entry of
        ``ptxas -v``'s report."""
        text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3oneILi0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3oneILi0EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 107 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z3twov' for 'sm_90a'
ptxas info    : Function properties for _Z3twov
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 2048 bytes smem
"""
        assert _build.parse_ptxas(text) == [
            {"function": "_Z3oneILi0EEvv", "registers": 107,
             "smem_bytes": 0, "spill_stores": 0, "spill_loads": 0},
            {"function": "_Z3twov", "registers": 64, "smem_bytes": 2048,
             "spill_stores": 8, "spill_loads": 12}]

    def test_build_keeps_the_ptxas_report(self, monkeypatch, tmp_path):
        nvcc = self._fake_nvcc(
            tmp_path, 'echo "ptxas info    : Used 9 registers" >&2\n'
                      'for a; do [ "$prev" = "-o" ] && touch "$a"; '
                      'prev=$a; done')
        self._fake_tree(monkeypatch, tmp_path, nvcc)
        _build.build_kernel("one")
        with open(_build.report_path("one")) as f:
            assert "Used 9 registers" in f.read()
        assert "-Xptxas" in _build.NVCC_FLAGS

    def test_failed_build_raises(self, monkeypatch, tmp_path):
        nvcc = self._fake_nvcc(tmp_path, 'echo "error: bad" >&2; exit 2')
        self._fake_tree(monkeypatch, tmp_path, nvcc)
        with pytest.raises(RuntimeError, match="nvcc failed on one.cu"):
            _build.build_kernel("one")
        assert not os.listdir(tmp_path / "build")

