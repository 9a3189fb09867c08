"""rec_tpu_torch.io writes .rec files byte-identical to rec_tpu.io and reads
the files rec_tpu writes (both entropy codecs, with the residual section)."""

import numpy as np
import pytest
import torch

from rec_tpu import io as jio
from rec_tpu.io import residual as jres
from rec_tpu_torch import io as tio
from rec_tpu_torch.io import residual as tres

torch.set_num_threads(2)


def _latents(seed=0, n_latents=3, n_blocks=9, P=24, S=36):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_latents):
        counts = rs.randint(1, P + 1, size=n_blocks).astype(np.int32)
        idx = rs.randint(0, S, size=(n_blocks, P)).astype(np.int32)
        for b, c in enumerate(counts):
            idx[b, c:] = 0
        out.append((idx, counts))
    return out


def _images(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(32, 32, 3).astype(np.float32)
    recon = np.clip(x + rs.randn(32, 32, 3).astype(np.float32) * 0.02,
                    0.0, 0.999)
    return x, recon


@pytest.mark.parametrize("codec", ["ac", "rans"])
def test_write_rec_byte_identical(tmp_path, codec):
    latents = _latents()
    x, recon = _images()
    payload, _ = jres.encode_residual(x, recon)
    assert tres.encode_residual(x, recon)[0] == payload
    kw = dict(seed=1234, image_shape=(32, 32, 3), block_size=1000,
              max_index=36, latents=latents, residual=payload, codec=codec)
    a, b = tmp_path / "jax.rec", tmp_path / "torch.rec"
    na = jio.write_rec(str(a), **kw)
    nb = tio.write_rec(str(b), **kw)
    assert na == nb
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("codec", ["ac", "rans"])
def test_reads_rec_tpu_files(tmp_path, codec):
    latents = _latents(1)
    x, recon = _images(1)
    payload, _ = jres.encode_residual(x, recon)
    path = str(tmp_path / "img.rec")
    jio.write_rec(path, seed=77, image_shape=(32, 32, 3), block_size=1000,
                  max_index=36, latents=latents, residual=payload,
                  codec=codec)
    seed, shape, block, got, section = tio.read_rec(
        path, max_partitions=24, with_residual=True)
    assert (seed, shape, block) == (77, (32, 32, 3), 1000)
    for (wi, wc), (gi, gc) in zip(latents, got):
        np.testing.assert_array_equal(wi, gi)
        np.testing.assert_array_equal(wc, gc)
    out = tres.decode_residual(section, recon)
    np.testing.assert_array_equal(tres.quantize(out), tres.quantize(x))


def test_custom_counts_round_trip(tmp_path):
    latents = _latents(2, n_latents=1)
    counts = np.arange(1, 38, dtype=np.int64)
    path = str(tmp_path / "c.rec")
    tio.write_rec(path, seed=5, image_shape=(16, 16, 3), block_size=1000,
                  max_index=36, latents=latents, index_counts=counts)
    with pytest.raises(ValueError, match="custom index counts"):
        tio.read_rec(path)
    _, _, _, got = tio.read_rec(path, index_counts=counts, max_partitions=24)
    np.testing.assert_array_equal(got[0][0], latents[0][0])
