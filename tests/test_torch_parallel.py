"""rec_tpu_torch's parallel layer vs rec_tpu's on the virtual 8-device CPU
mesh: the sharded block codec over ``[cpu] * k`` meshes (k = 1, 2, 3, 8;
both coders; a block count that 3 and 8 do not divide) against
``rec_tpu.parallel.sharded_encode_blocks`` bitwise, decodes in both
directions, row ownership against ``global_batch_array``, the mesh
helpers and the profiling helpers.  The data-parallel train step is in
test_torch_dp_train.py, ``scaling_bench`` in test_torch_scaling_bench.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import BeamSearchCoder as JBeam
from rec_tpu.coding import GaussianCoder as JGauss
from rec_tpu.coding import GaussianParams as JG
from rec_tpu.parallel import make_mesh as j_make_mesh
from rec_tpu.parallel import sharded_decode_blocks as j_sharded_decode
from rec_tpu.parallel import sharded_encode_blocks as j_sharded_encode
from rec_tpu.parallel.serving import global_batch_array
from rec_tpu_torch.coding import BeamSearchCoder as TBeam
from rec_tpu_torch.coding import GaussianCoder as TGauss
from rec_tpu_torch.coding import GaussianParams as TG
from rec_tpu_torch.parallel import (Mesh, local_rows, make_mesh,
                                    process_rows, replicate, shard_images,
                                    shard_rows, sharded_decode_blocks,
                                    sharded_encode_blocks)
from rec_tpu_torch.utils.profiling import device_trace, span

torch.set_num_threads(2)

SHAPE = (10, 10, 8)   # 800 dims in blocks of 64: 13 blocks
CODERS = {
    "beam": (JBeam(kl_per_partition=3.0, n_beams=4, extra_samples=1.2,
                   block_size=64, max_partitions=12),
             TBeam(kl_per_partition=3.0, n_beams=4, extra_samples=1.2,
                   block_size=64, max_partitions=12)),
    "importance": (JGauss(coding_bits=6, block_size=64, max_partitions=12),
                   TGauss(coding_bits=6, block_size=64, max_partitions=12)),
}


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def latent():
    rs = np.random.RandomState(0)
    loc = (0.3 * rs.randn(*SHAPE)).astype(np.float32)
    scale = np.exp(0.2 * rs.randn(*SHAPE)).astype(np.float32)
    zeros, ones = np.zeros(SHAPE, np.float32), np.ones(SHAPE, np.float32)
    return ((JG(jnp.asarray(loc), jnp.asarray(scale)),
             JG(jnp.asarray(zeros), jnp.asarray(ones))),
            (TG(torch.from_numpy(loc), torch.from_numpy(scale)),
             TG(torch.from_numpy(zeros), torch.from_numpy(ones))))


class TestShardedCodec:
    @pytest.mark.parametrize("k", [1, 2, 3, 8])
    @pytest.mark.parametrize("coder", sorted(CODERS))
    def test_encode_matches_jax(self, latent, coder, k):
        """Indices, counts and sample bitwise rec_tpu's on a k-device mesh
        and the port's own one-device encode; 13 blocks pad to 15 and 16
        on the 3- and 8-entry meshes."""
        (jt, jc), (tt, tc) = latent
        jcoder, tcoder = CODERS[coder]
        ji, jn, js = j_sharded_encode(jcoder, jt, jc, 42, j_make_mesh(k))
        got = sharded_encode_blocks(tcoder, tt, tc, 42, Mesh(["cpu"] * k))
        assert got.indices.shape == (13, 12)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(got.counts.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(_bits(got.sample), _bits(js))
        one = tcoder.encode(tt, tc, 42)
        assert torch.equal(one.indices, got.indices)
        assert torch.equal(one.sample.view(torch.int32),
                           got.sample.view(torch.int32))

    @pytest.mark.parametrize("k", [2, 3, 8])
    @pytest.mark.parametrize("coder", sorted(CODERS))
    def test_decode_both_directions(self, latent, coder, k):
        """The port's sharded decode of rec_tpu's indices is rec_tpu's
        sample, and rec_tpu's sharded decode of the port's is the port's,
        bitwise."""
        (jt, jc), (tt, tc) = latent
        jcoder, tcoder = CODERS[coder]
        want = jcoder.encode(jt, jc, 7)
        got = sharded_decode_blocks(tcoder, tc, np.array(want.indices),
                                    np.array(want.counts), 7,
                                    Mesh(["cpu"] * k))
        np.testing.assert_array_equal(_bits(got), _bits(want.sample))
        mine = tcoder.encode(tt, tc, 9)
        theirs = j_sharded_decode(jcoder, jc, jnp.asarray(mine.indices),
                                  jnp.asarray(mine.counts), 9,
                                  j_make_mesh(k))
        np.testing.assert_array_equal(_bits(theirs), _bits(mine.sample))


class TestMesh:
    def test_cpu_mesh_repeats_its_device(self):
        mesh = make_mesh(3, device="cpu")
        assert mesh == (torch.device("cpu"),) * 3 and mesh.repeats
        assert "repeating" in mesh.describe()
        assert make_mesh(device="cpu") == (torch.device("cpu"),)

    def test_bare_cuda_entries_raise(self):
        with pytest.raises(ValueError, match="cuda:k"):
            Mesh(["cuda", "cuda"])

    @pytest.mark.parametrize("n", [None, 2, 5])
    def test_make_mesh_takes_visible_cards_or_raises(self, monkeypatch, n):
        """Two visible cards (mocked): None and 2 give cuda:0, cuda:1; 5
        raises where rec_tpu's make_mesh quietly takes two."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        if n == 5:
            with pytest.raises(ValueError, match="2 visible"):
                make_mesh(n)
            return
        mesh = make_mesh(n)
        assert mesh == (torch.device("cuda", 0), torch.device("cuda", 1))
        assert not mesh.repeats

    def test_shard_rows_and_images(self):
        x = np.arange(12, dtype=np.float32).reshape(6, 2)
        parts = shard_rows(x, Mesh(["cpu"] * 3))
        assert [p.tolist() for p in parts] == [x[:2].tolist(),
                                               x[2:4].tolist(),
                                               x[4:].tolist()]
        with pytest.raises(ValueError, match="multiple"):
            shard_rows(x, Mesh(["cpu"] * 4))
        shares = shard_images(x, [5, 6, 7, 8, 9, 10], Mesh(["cpu"] * 2))
        assert [s for _, s in shares] == [[5, 6, 7], [8, 9, 10]]

    def test_replicate_shares_its_own_device(self):
        model = torch.nn.Linear(2, 2)
        assert replicate(model, Mesh(["cpu"] * 3)) == [model] * 3


class TestRows:
    @pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
    @pytest.mark.parametrize("batch_size", [5, 8, 13])
    def test_local_rows_match_global_batch_array(self, n_dev, batch_size):
        """The rows JAX's 1-D sharding gives device d of an n-device mesh
        are the rows of (process r, entry e) for every split of the mesh
        into world x per-process entries (process-major device order); the
        batch is padded to a multiple of the mesh as serve pads it."""
        batch = -(-batch_size // n_dev) * n_dev
        arr = global_batch_array(np.arange(batch), j_make_mesh(n_dev))
        want = {}
        devices = list(j_make_mesh(n_dev).devices.flat)
        for shard in arr.addressable_shards:
            want[devices.index(shard.device)] = np.asarray(
                shard.data).tolist()
        for world in [w for w in (1, 2, 4, 8) if n_dev % w == 0]:
            per = n_dev // world
            for r in range(world):
                for e in range(per):
                    got = list(local_rows(batch, r, world, e, per))
                    assert got == want[r * per + e], (world, r, e)
                rows = process_rows(batch, r, world, per)
                assert list(rows) == sum((want[r * per + e]
                                          for e in range(per)), [])

    def test_uneven_batch_raises(self):
        with pytest.raises(ValueError, match="multiple"):
            local_rows(6, 0, 2, 0, 2)


def test_device_trace_writes_a_trace_with_annotations(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        with span("rec_tpu_torch_span"):
            torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert "rec_tpu_torch_span" in names
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert traces, os.listdir(tmp_path)
