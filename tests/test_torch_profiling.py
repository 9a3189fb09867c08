"""rec_tpu_torch's recorder (``utils/profiling.py``): spans at the layer
boundaries of a tiny RVAE's ``compress_batch`` only under a
``torch.profiler`` session, with their parents, request ids and cards, the
replay's row counts, set-up spans with no session, the bounded buffer, the
counters under threads, and outputs bit for bit those with tracing off."""

import sys
import threading
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rec_tpu_torch.coding import BeamSearchCoder, rng
from rec_tpu_torch.models.resnet_vae import (BidirectionalResNetVAE,
                                             ResNetVAEConfig)
from rec_tpu_torch.parallel import Mesh, make_batch_compress
from rec_tpu_torch.utils import profiling
from rec_tpu_torch.utils.profiling import Recorder

torch.set_num_threads(2)

P = 6
CODER = BeamSearchCoder(n_beams=3, extra_samples=1.0, block_size=64,
                        max_partitions=P)
CFG = ResNetVAEConfig(num_res_blocks=2, deterministic_filters=8,
                      stochastic_filters=4)
SHAPE = (16, 16, 3)          # latents of 8 x 8 x 4: 4 blocks an image
SEEDS = [11, 12, 13, 14]
HOT = {"model.compress_batch", "model.decompress_batch", "coder.split", "coder.replay", "replay.keys", "replay.schedule",
       "replay.normals", "replay.contract", "kernel.mega_beam"}


def _tracing():
    return profile(activities=[ProfilerActivity.CPU])


def _new_spans(before: int) -> list:
    return profiling.collect()["spans"][before:]


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m = BidirectionalResNetVAE(CFG, CODER, seed=3, device="cpu")
    g = torch.Generator().manual_seed(5)
    images = torch.rand((1,) + SHAPE, generator=g) - 0.5
    noise = torch.randn((CFG.num_res_blocks, 1, 8, 8, 4), generator=g)
    n = len(profiling.collect()["spans"])
    m.data_dependent_init(images, noise)
    m.ddi_spans = [s for s in _new_spans(n) if s.name == "setup.ddi"]
    return m


@pytest.fixture(scope="module")
def images():
    g = torch.Generator().manual_seed(7)
    return torch.rand((len(SEEDS),) + SHAPE, generator=g) - 0.5


def test_setup_spans_record_with_no_session(model):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert len(model.ddi_spans) == 1
    ddi = model.ddi_spans[0]
    assert ddi.card == -1 and ddi.t1_ns > ddi.t0_ns
    rng.normal_table.cache_clear()
    rng.erfinv_table.cache_clear()
    n = len(profiling.collect()["spans"])
    table = rng.normal_table(torch.device("cpu"))
    (built,) = _new_spans(n)
    assert built.name == "setup.normal_table" and built.parent == -1
    assert built.card == -1 and built.t1_ns > built.t0_ns
    assert table.shape == (1 << 23,)


def test_no_hot_path_span_without_a_session(model, images):
    rng.normal_table(torch.device("cpu"))
    n = len(profiling.collect()["spans"])
    model.compress_batch(images, SEEDS)
    assert not {s.name for s in _new_spans(n)} & HOT


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1)
    return t.view(torch.int32) if t.is_floating_point() else t


def _descends(spans, i, root):
    while spans[i].parent >= 0:
        i = spans[i].parent
    return i == root


@pytest.mark.parametrize("entry", ["compress_batch", "mesh"])
def test_spans_under_a_session(model, images, entry):
    rng.normal_table(torch.device("cpu"))
    off = model.compress_batch(images, SEEDS)
    call = (make_batch_compress(model, Mesh(["cpu", "cpu"]))
            if entry == "mesh" else
            lambda x, s: model.compress_batch(x, s))
    n = len(profiling.collect()["spans"])
    with _tracing():
        outs = [call(images, SEEDS) for _ in range(2)]
    spans = profiling.collect()["spans"]
    new = spans[n:]
    # Over a mesh each replica's call is a root of its own.
    roots = [n + i for i, s in enumerate(new) if s.parent == -1]
    assert [spans[r].name for r in roots] == \
        ["model.compress_batch"] * (4 if entry == "mesh" else 2)
    assert len({spans[r].request for r in roots}) == len(roots)
    for i, s in enumerate(new, n):
        assert s.t1_ns is not None and s.t0_ns <= s.t1_ns
        assert s.card == -1
        root = next(r for r in reversed(roots) if r <= i)
        assert _descends(spans, i, root) and s.request == spans[root].request
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    names = [s.name for s in new]
    per_call = 2 if entry == "mesh" else 1
    assert names.count("model.compress_batch") == 2 * per_call
    assert names.count("coder.replay") == 2 * per_call * CFG.num_res_blocks
    for name in ("replay.keys", "replay.schedule", "replay.normals",
                 "replay.contract"):
        kids = [s for s in new if s.name == name]
        assert len(kids) == names.count("coder.replay")
        assert all(spans[s.parent].name == "coder.replay" for s in kids)
    assert names.count("coder.split") == 2 * names.count("coder.replay")
    # Tracing changes no bit of the outputs.
    for out in outs:
        for k in ("indices", "counts", "kl", "reconstruction"):
            assert torch.equal(_bits(out[k]), _bits(off[k])), k


def test_replay_counts_rows_and_live_rows(model, images):
    rng.normal_table(torch.device("cpu"))
    n = len(profiling.collect()["spans"])
    with _tracing():
        out = model.compress_batch(images, SEEDS)
        rec = model.decompress_batch(SHAPE[:2], out["indices"],
                                     out["counts"], SEEDS)
    replays = [s for s in _new_spans(n) if s.name == "coder.replay"]
    counts = out["counts"].numpy()                     # (B, N, blocks)
    B, G, nb = counts.shape
    # Encode's replays run in block order, then the decode's.
    want = [int(np.minimum(counts[:, g], P).sum()) for g in range(G)] * 2
    assert [s.counts["live_rows"] for s in replays] == want
    assert [s.counts["rows"] for s in replays] == [B * nb * P] * (2 * G)
    splits = [s for s in _new_spans(n) if s.name == "coder.split"]
    assert {s.counts["blocks"] for s in splits} == {B * nb}
    assert torch.equal(_bits(rec), _bits(out["reconstruction"]))


def test_children_take_the_parents_card():
    r = Recorder()
    with _tracing():
        with r.span("root", card=3, images=2):
            with r.span("child"):
                with r.span("other", card=1):
                    pass
            with r.span("host", card=torch.device("cpu")):
                pass
        with r.span("root"):
            pass
    spans = r.collect()["spans"]
    assert [(s.name, s.request, s.parent, s.card) for s in spans] == [
        ("root", 0, -1, 3), ("child", 0, 0, 3), ("other", 0, 1, 1),
        ("host", 0, 0, -1), ("root", 1, -1, -1)]
    assert spans[0].counts == {"images": 2}


def test_the_buffer_drops_its_oldest_records():
    r = Recorder(capacity=8)
    with _tracing():
        with r.span("outer"):
            for i in range(10):
                with r.span("inner", i=i):
                    pass
    got = r.collect()
    assert got["dropped"] == 3
    spans = got["spans"]
    assert [s.counts["i"] for s in spans if s.name == "inner"] == \
        list(range(2, 10))
    # The outer span was dropped: its children point nowhere.
    assert all(s.parent == -1 for s in spans)


def test_tensor_counts_are_read_in_collect():
    r = Recorder(capacity=4)
    live = torch.tensor([1, 5, 2])
    with _tracing():
        with r.span("x", live=live, rows=9):
            pass
        # Sums, not the tensors, are held: the recorder keeps none alive.
        gone = weakref.ref(live)
        del live
        assert gone() is None
        for i in range(5):
            with r.span("y", i=i) as sp:
                sp.count(live=torch.full((2, 3), i))
    got = r.collect()
    assert got["dropped"] == 2
    assert [s.counts for s in got["spans"]] == [
        {"i": i, "live": 6 * i} for i in range(1, 5)]
    assert all(isinstance(s.counts["live"], int) for s in got["spans"])


@pytest.mark.parametrize("source", ["events", "kineto"])
def test_span_events_are_annotations(source):
    with _tracing() as prof:
        with profiling.span("coder.replay"):
            torch.ones(3).add_(1)
    if source == "events":
        events = [(e.name, e) for e in prof.events()]
    else:
        events = [(e.name(), e) for e in
                  prof.profiler.kineto_results.events()]
    flags = {name: profiling.is_annotation(e) for name, e in events}
    assert flags.pop("coder.replay") is True
    assert flags and not any(flags.values())


def test_off_span_is_shared():
    assert profiling.span("a") is profiling.span("b", rows=3)


def test_threads_keep_their_own_stacks_and_counts():
    r = Recorder()
    n_threads, reps = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _tracing():
            def work(k):
                for _ in range(reps):
                    with r.span("root", card=k):
                        with r.span("leaf"):
                            r.add("launches", f"cuda:{k % 4}")

            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = r.collect()["spans"]
    assert len(spans) == 2 * n_threads * reps
    roots = [s for s in spans if s.name == "root"]
    assert len({s.request for s in roots}) == n_threads * reps
    for s in spans:
        if s.name == "leaf":
            p = spans[s.parent]
            assert p.name == "root" and p.request == s.request
            assert p.card == s.card
    assert r.counter("launches") == {f"cuda:{k}": n_threads // 4 * reps
                                     for k in range(4)}
    before = r.counter("launches")
    r.add("launches", "cuda:1", 2)
    assert r.counter("launches", since=before) == {"cuda:1": 2}
