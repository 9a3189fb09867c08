"""The beam-search replay (``ops/replay.py``): its plain version against the
encoder's streams on the CPU, the wrapper's dispatch and argument checks,
the build's header rule, and, on a card, the kernel against the plain
version bit for bit.

The plain version is held against an independent replay written from the
encoder's side of the stream contract: block by block, only over the live
steps, each step's row taken out of the whole candidate stream
``rng.normal_stream(key, (S, D))`` with the key derived in Python integers.
Walking only the live steps is what the kernel does, so the CPU tests also
hold the kernel's premise that a dead step adds nothing.

This module imports no JAX, so it also runs on a GPU machine without it;
the tests' conftest.py configures JAX, so leave it out there:

    python -m pytest --noconftest tests/test_torch_replay.py
"""

import itertools
import os
import pathlib
import stat
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from rec_tpu_torch.coding import BeamSearchCoder  # noqa: E402
from rec_tpu_torch.coding import beam_search, rng  # noqa: E402
from rec_tpu_torch.coding.gauss import GaussianParams  # noqa: E402
from rec_tpu_torch.coding.partition import schedule_table  # noqa: E402
from rec_tpu_torch.ops import _build, replay  # noqa: E402
from rec_tpu_torch.ops.threefry_normal import (  # noqa: E402
    M32, fma_f32_exact, sqrt_f32, threefry2x32)
from rec_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

STREAMS = ("fmix", "threefry")
# (stream, shared_pool, learned ratios, N, P, D): the grid both the CPU
# and the card tests cover.
GRID = list(itertools.product(STREAMS, (False, True), (False, True),
                              (0, 1, 9), (1, 24), (7, 1000)))
GRID_IDS = ["-".join((s, "pool" if p else "beams", "ratios" if r else "law",
                      f"n{n}", f"p{pp}", f"d{d}"))
            for s, p, r, n, pp, d in GRID]


def _ratios(P, learned):
    if not learned:
        return None
    return tuple(float(r) for r in
                 np.random.RandomState(P).uniform(0.2, 0.8, P))


def _blocks(N, D, seed=0):
    """A learned prior's coders (non-zero locs, non-unit scales) and
    targets around them whose spread gives counts from 1 to saturated."""
    rs = np.random.RandomState(seed)
    c_loc = (rs.randn(N, D) * 0.5).astype(np.float32)
    c_scale = np.exp(rs.randn(N, D) * 0.3).astype(np.float32)
    spread = np.resize([0.02, 0.05, 0.1, 0.2, 0.4, 0.8, 1.5], N)[:, None]
    t_loc = (c_loc + rs.randn(N, D) * spread * c_scale).astype(np.float32)
    t_scale = (c_scale * 0.7).astype(np.float32)
    as_t = torch.from_numpy
    bkeys = rng.block_key(rng.root_key(seed + 7, "cpu"), torch.arange(N))
    return (GaussianParams(as_t(t_loc), as_t(t_scale)),
            GaussianParams(as_t(c_loc), as_t(c_scale)), bkeys)


def _live_replay(coders, w, indices, counts, bkeys, S, stream, shared_pool):
    """The replay from the encoder's view of the streams (see the module
    docstring)."""
    N, D = coders.loc.shape
    P = w.shape[1]
    sqrt_w = sqrt_f32(w)
    out = torch.empty(N, D)
    for n in range(N):
        k1, k2 = (int(v) for v in bkeys[n])
        h = rng.FNV_OFFSET
        acc = torch.zeros(D)
        for t in range(min(int(counts[n]), P)):
            s1, s2 = threefry2x32(k1, k2, 0, t)
            key = torch.tensor(threefry2x32(
                s1, s2, 0, rng.POOL_TAG if shared_pool else h))
            i = int(indices[n, t])
            eps = rng.normal_stream(key, (S, D), stream=stream)[i]
            acc = fma_f32_exact(sqrt_w[n, t], eps, acc)
            h = ((h ^ i) * rng.FNV_PRIME) & M32
        out[n] = fma_f32_exact(coders.scale[n], acc, coders.loc[n])
    return out


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("stream,shared_pool,learned,N,P,D", GRID,
                         ids=GRID_IDS)
def test_plain_version_is_the_encoders_streams(stream, shared_pool, learned,
                                               N, P, D):
    """The encoder's indices replayed by the plain version (which is the
    sample the encoder reports and what decode gives) equal the
    independent live-step replay, bit for bit."""
    cfg = beam_search.BeamSearchConfig(n_beams=2, max_partitions=P,
                                       stream=stream,
                                       shared_pool=shared_pool)
    ratios = _ratios(P, learned)
    targets, coders, bkeys = _blocks(N, D, seed=N + P)
    enc = beam_search.encode_blocks(cfg, targets, coders, bkeys, ratios)
    counts = torch.clamp(enc.count.to(torch.int64), max=P)
    w, _ = schedule_table(counts, P, ratios, device="cpu")
    plain = replay.replay_blocks_ref(coders, w, enc.indices, counts, bkeys,
                                     stream=stream, shared_pool=shared_pool)
    want = _live_replay(coders, w, enc.indices, counts, bkeys,
                        cfg.n_samples, stream, shared_pool)
    dec = beam_search.decode_blocks(cfg, coders, enc.indices, enc.count,
                                    bkeys, ratios)
    assert plain.shape == (N, D)
    assert torch.equal(_bits(plain), _bits(want))
    assert torch.equal(_bits(enc.sample), _bits(want))
    assert torch.equal(_bits(dec), _bits(want))


@pytest.mark.parametrize("shared_pool", [False, True])
@pytest.mark.parametrize("stream", STREAMS)
def test_cpu_tensors_take_the_plain_version(monkeypatch, stream,
                                            shared_pool):
    """CPU tensors never reach the kernel's wrapper, and the launch counter
    does not move."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("CPU tensors reached the kernel")

    monkeypatch.setattr(replay, "launch_kernel", no_kernel)
    coders, idx, counts, bkeys = chip_smoke.replay_inputs(
        "cpu", 5, 40, 12, 36, 12, seed=3)
    w, _ = schedule_table(counts, 12, device="cpu")
    before = profiling.counter("replay.launches")
    got = replay.replay_blocks(coders, w, idx, counts, bkeys, stream=stream,
                               shared_pool=shared_pool)
    cfg = beam_search.BeamSearchConfig(max_partitions=12, stream=stream,
                                       shared_pool=shared_pool)
    dec = beam_search.decode_blocks(cfg, coders, idx, counts, bkeys)
    assert profiling.counter("replay.launches", since=before) == {}
    want = replay.replay_blocks_ref(coders, w, idx, counts, bkeys,
                                    stream=stream, shared_pool=shared_pool)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(dec), _bits(want))


def _kernel_args(N=3, D=8, P=4):
    coders, idx, counts, bkeys = chip_smoke.replay_inputs(
        "cpu", N, D, P, 36, P, seed=1)
    w, _ = schedule_table(counts, P, device="cpu")
    return dict(loc=coders.loc, scale=coders.scale, w=w, indices=idx,
                counts=counts, bkeys=bkeys)


# (what is wrong, the change to the arguments, the error it must raise).
BAD_ARGS = (
    ("loc_dtype", lambda a: a.update(loc=a["loc"].double()), "loc must be"),
    ("w_dtype", lambda a: a.update(w=a["w"].half()), "w must be"),
    ("indices_dtype", lambda a: a.update(indices=a["indices"].long()),
     "indices must be"),
    ("counts_dtype", lambda a: a.update(counts=a["counts"].int()),
     "counts must be"),
    ("bkeys_dtype", lambda a: a.update(bkeys=a["bkeys"].int()),
     "bkeys must be"),
    ("scale_shape", lambda a: a.update(scale=a["scale"][:2]),
     "scale must have shape"),
    ("indices_shape", lambda a: a.update(indices=a["indices"][:, :3]),
     "indices must have shape"),
    ("bkeys_shape", lambda a: a.update(bkeys=a["bkeys"][:, :1]),
     "bkeys must have shape"),
    ("loc_rank", lambda a: a.update(loc=a["loc"][0]), r"loc \(N, D\)"),
    ("loc_strided",
     lambda a: a.update(loc=torch.cat([a["loc"], a["loc"]], 1)[:, ::2]),
     "loc must be contiguous"),
    ("w_transposed", lambda a: a.update(w=a["w"].t().contiguous().t()),
     "w must be contiguous"),
    ("cpu", lambda a: None, "one CUDA device"),
)


@pytest.mark.parametrize("change,match", [(c, m) for _, c, m in BAD_ARGS],
                         ids=[n for n, _, _ in BAD_ARGS])
def test_wrapper_checks_arguments(change, match):
    args = _kernel_args()
    change(args)
    with pytest.raises(ValueError, match=match):
        replay.launch_kernel(**args, stream="fmix", shared_pool=False)


def test_wrapper_rejects_an_unknown_stream():
    with pytest.raises(ValueError, match="unknown stream"):
        replay.launch_kernel(**_kernel_args(), stream="philox",
                             shared_pool=False)


@pytest.mark.parametrize("header_newer", [True, False])
def test_header_newer_than_library_is_stale(monkeypatch, tmp_path,
                                            header_newer):
    """A shared ``csrc/*.cuh`` newer than a library rebuilds it; an older
    one leaves it."""
    log = tmp_path / "log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {log}\nfor a; do '
                    f'[ "$prev" = "-o" ] && touch "$a"; prev=$a; done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "one.cu").write_text('#include "shared.cuh"\n')
    header = csrc / "shared.cuh"
    header.write_text("// shared\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    lib = _build.build_kernel("one")
    built = os.path.getmtime(lib)
    header_at = built - (10 if header_newer else 100)
    for path, at in ((csrc / "one.cu", built - 100), (header, header_at),
                     (lib, built - 50)):
        os.utime(path, (at, at))
    assert _build._stale("one") == header_newer
    _build.build_kernel("one")
    assert len(log.read_text().splitlines()) == (2 if header_newer else 1)
    assert not _build._stale("one")


# ---------------------------------------------------------------------------
# On the card (``cuda``): the kernel against the plain version on the CPU,
# through ``beam_search.decode_blocks`` (``chip_smoke.check_replay``).
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stream,shared_pool,learned,N,P,D", GRID,
                         ids=GRID_IDS)
def test_kernel_matches_plain_version_on_card(stream, shared_pool, learned,
                                              N, P, D):
    got = chip_smoke.check_replay(_card(), N, D, P, stream, shared_pool,
                                  _ratios(P, learned), seed=N + P + D)
    assert got["mismatches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("kind", ["zero", "full", "above", "mixed"])
def test_kernel_edge_counts_on_card(stream, kind):
    """Counts of 0, P and above P (the replay clamps to P)."""
    N, P = 12, 24
    counts = {"zero": [0] * N, "full": [P] * N, "above": [P + 5] * N,
              "mixed": [0, 1, P - 1, P, P + 1, 2 * P, 3, 0, P, 7, P + 9, 1]
              }[kind]
    chip_smoke.check_replay(_card(), N, 1000, P, stream, counts=counts,
                            seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("N,P,S,hi", [(72, 24, 36, 24), (302, 24, 20, 13),
                                      (408, 32, 20, 13)],
                         ids=["n72", "n302", "n408"])
def test_kernel_serving_shapes_on_card(stream, N, P, S, hi):
    chip_smoke.check_replay(_card(), N, 1000, P, stream, S=S, hi=hi,
                            seed=N)


@pytest.mark.cuda
@pytest.mark.parametrize("shared_pool", [False, True])
@pytest.mark.parametrize("stream", STREAMS)
def test_encode_sample_equals_decode_on_card(stream, shared_pool):
    """The coder on the card: encode's sample == GPU decode == CPU decode,
    one replay launch in each of encode and decode."""
    dev = _card()
    targets, coders, _ = _blocks(3, 1000, seed=2)
    shape = (3, 1000)
    coder = BeamSearchCoder(max_partitions=24, stream=stream,
                            shared_pool=shared_pool)
    t = GaussianParams(targets.loc.to(dev), targets.scale.to(dev))
    c = GaussianParams(coders.loc.to(dev), coders.scale.to(dev))
    before = profiling.counter("replay.launches")
    enc = coder.encode(t, c, 77)
    dec = coder.decode(c, enc.indices, enc.counts, 77)
    torch.cuda.synchronize()
    assert sum(profiling.counter("replay.launches",
                                 since=before).values()) == 2
    dec_cpu = coder.decode(coders, enc.indices.cpu(), enc.counts.cpu(), 77)
    assert enc.sample.shape == shape
    assert torch.equal(_bits(enc.sample).cpu(), _bits(dec).cpu())
    assert torch.equal(_bits(dec).cpu(), _bits(dec_cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", STREAMS)
def test_kernel_launches_on_the_tensors_card(stream):
    """Tensors on cuda:1 launch on cuda:1 (run on a machine with more than
    one card) while cuda:0 is the current device."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    with torch.cuda.device(0):
        got = chip_smoke.check_replay(torch.device("cuda:1"), 9, 1000, 24,
                                      stream, seed=11)
    assert got["launches"] == 1
