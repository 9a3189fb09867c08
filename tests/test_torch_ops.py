"""rec_tpu_torch.ops vs rec_tpu.ops on JAX-CPU: candidate scoring (B2), the
beam-search wrapper's block-axis chunking (B1), and the one nvcc build
path.  The CUDA kernels themselves run only on the card (``cuda`` marker)."""

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
from rec_tpu_torch.ops import _build
from rec_tpu_torch.ops import beam_score as tscore
from rec_tpu_torch.ops import mega_beam as tmb
from rec_tpu_torch.ops import score_candidates as t_score_candidates

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
        ta, tb, tc = tscore._quadratic_coeffs(tn, td)
        assert _ulp(np.asarray(ja), ta.numpy()).max() <= 1
        assert _ulp(np.asarray(jb), tb.numpy()).max() <= 1
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-6)

    def test_cpu_tensors_take_the_plain_version(self):
        rs = np.random.RandomState(2)
        x = torch.tensor(rs.randn(6, 40), dtype=torch.float32)
        a, b = torch.randn(40), torch.randn(40)
        c = torch.tensor(0.5)
        before = tscore.score_rows.launches
        got = tscore.score_rows(x, a, b, c)
        assert tscore.score_rows.launches == before
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

    def test_failed_build_raises(self, monkeypatch, tmp_path):
        nvcc = self._fake_nvcc(tmp_path, 'echo "error: bad" >&2; exit 2')
        self._fake_tree(monkeypatch, tmp_path, nvcc)
        with pytest.raises(RuntimeError, match="nvcc failed on one.cu"):
            _build.build_kernel("one")
        assert not os.listdir(tmp_path / "build")


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(720, 1024), (720, 1000), (37, 33)])
def test_beam_score_kernel_matches_plain_version_on_card(N, D):
    """The CUDA kernel against its plain version on the card: the error
    relative to sum_d |(a x + b) x| + |c| within (D + 1) 2^-24."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rs = np.random.RandomState(N + D)
    dev = torch.device("cuda")
    x = torch.tensor(rs.randn(N, D), dtype=torch.float32, device=dev)
    a = torch.tensor(rs.randn(D), dtype=torch.float32, device=dev)
    b = torch.tensor(rs.randn(D), dtype=torch.float32, device=dev)
    c = torch.tensor(1.5, device=dev)
    got = tscore.launch_kernel(x, a, b, c)
    ref = tscore.score_candidates_ref(x, a, b, c)
    mag = torch.sum(torch.abs((a * x + b) * x), dim=-1) + 1.5
    assert float(torch.max(torch.abs(got - ref) / mag)) <= (D + 1) * 2 ** -24
