"""The port's quantization and bucket-store layouts against the JAX
package: bit-equal int8 and byte-equal store arrays on the same input."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
from learnedmetricindex_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from learnedmetricindex_tpu.ops.quantize import quantize_rows_np
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore
from learnedmetricindex_tpu_torch.ops import quantize

torch.set_num_threads(2)


def _rows(seed, n=500, d=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * rng.uniform(1e-3, 50, (n, 1)).astype(np.float32)
    x[0] = 0.0  # the EPS floor
    x[1, :] = 0.5  # round-half cases after scaling
    x[2, 0] = 127.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_bit_equal_to_numpy_and_jax(seed):
    """Values and scales are bit-equal to the numpy version (which packs
    the int8 stores); the values are bit-equal to the jitted JAX version
    too.  Its scales can be one ulp off, as they are against its own
    numpy version: XLA turns the division by 127 into a multiply by the
    reciprocal."""
    x = _rows(seed)
    q, sc = quantize.quantize_rows(torch.as_tensor(x))
    q_np, sc_np = quantize_rows_np(x)
    q_jax, sc_jax = jax_quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), q_np)
    np.testing.assert_array_equal(sc.numpy().view(np.uint32), sc_np.view(np.uint32))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_jax))
    ulps = sc.numpy().view(np.int32).astype(np.int64) - np.asarray(sc_jax).view(np.int32)
    assert np.abs(ulps).max() <= 1
    deq = quantize.dequantize_rows(q, sc).numpy()
    np.testing.assert_allclose(deq, x, atol=float(sc.max()) / 2 + 1e-6)


def _layout(seed, n=700, d=16, nb=7, empty=3):
    data, _ = synthetic_blobs(n, d, 1, seed=seed)
    rng = np.random.default_rng(seed)
    bucket_ids = rng.integers(0, nb, size=n)
    bucket_ids[bucket_ids == empty] = empty + 1  # one empty bucket
    return data, bucket_ids, nb


def _assert_same_layout(port: BucketStore, ref: JaxStore, *, scales: bool):
    np.testing.assert_array_equal(port.chunk_ids.numpy(), np.asarray(ref.chunk_ids))
    np.testing.assert_array_equal(port.bucket_chunk_start, ref.bucket_chunk_start)
    assert port.bucket_chunk_start.dtype == ref.bucket_chunk_start.dtype
    np.testing.assert_array_equal(port.bucket_sizes, ref.bucket_sizes)
    np.testing.assert_array_equal(port.row_slot.numpy(), np.asarray(ref.row_slot))
    assert (port.chunk, port.n_buckets, port.n_chunks) == (ref.chunk, ref.n_buckets, ref.n_chunks)
    if scales:
        np.testing.assert_array_equal(
            port.chunk_scales.numpy().view(np.uint32),
            np.asarray(ref.chunk_scales).view(np.uint32),
        )


@pytest.mark.parametrize("chunk", [32, 64, 100])
def test_build_byte_equal(chunk):
    data, bucket_ids, nb = _layout(4)
    ref = JaxStore.build(data, bucket_ids, nb, chunk=chunk)
    port = BucketStore.build(data, bucket_ids, nb, chunk=chunk, device="cpu")
    _assert_same_layout(port, ref, scales=False)
    assert port.chunk_data.dtype == torch.float32
    np.testing.assert_array_equal(port.chunk_data.numpy(), np.asarray(ref.chunk_data))
    # no scales: padding slots are the ones with id 0
    np.testing.assert_array_equal(
        port.scales_flat().numpy(), (np.asarray(ref.chunk_ids).reshape(-1) > 0).astype(np.float32)
    )


def test_build_bfloat16_and_object_ids():
    data, bucket_ids, nb = _layout(5)
    object_ids = np.arange(1, len(data) + 1, dtype=np.int32)[::-1].copy()
    ref = JaxStore.build(data, bucket_ids, nb, chunk=64, dtype=jnp.bfloat16, object_ids=object_ids)
    port = BucketStore.build(data, bucket_ids, nb, chunk=64, dtype="bfloat16",
                             object_ids=object_ids, device="cpu")
    _assert_same_layout(port, ref, scales=False)
    assert port.chunk_data.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        port.chunk_data.float().numpy(), np.asarray(ref.chunk_data.astype(jnp.float32))
    )


@pytest.mark.parametrize("chunk", [32, 128])
def test_build_packed_int8_byte_equal(chunk):
    data, bucket_ids, nb = _layout(6, n=1500, d=32)
    ref = JaxStore.build_packed_int8(data, bucket_ids, nb, chunk=chunk)
    port = BucketStore.build_packed_int8(data, bucket_ids, nb, chunk=chunk, device="cpu")
    _assert_same_layout(port, ref, scales=True)
    assert port.chunk_data.dtype == torch.int8
    np.testing.assert_array_equal(port.chunk_data.numpy(), np.asarray(ref.chunk_data))


@pytest.mark.parametrize("slab_batch", [1, 3, 128])
def test_build_packed_device_equals_build_packed_int8(slab_batch):
    """Packing a quantized corpus where it lies gives the host-packed
    int8 store, padding slots zeroed."""
    data, bucket_ids, nb = _layout(7, n=1200, d=32)
    q, sc = quantize.quantize_rows(torch.as_tensor(data))
    ref = JaxStore.build_packed_int8(data, bucket_ids, nb, chunk=64)
    port = BucketStore.build_packed_device(q, bucket_ids, nb, chunk=64, row_scales=sc,
                                           slab_batch=slab_batch)
    _assert_same_layout(port, ref, scales=True)
    np.testing.assert_array_equal(port.chunk_data.numpy(), np.asarray(ref.chunk_data))


def test_build_packed_device_f32_equals_build():
    data, bucket_ids, nb = _layout(8)
    ref = JaxStore.build(data, bucket_ids, nb, chunk=64)
    port = BucketStore.build_packed_device(torch.as_tensor(data), bucket_ids, nb, chunk=64)
    _assert_same_layout(port, ref, scales=False)
    assert port.chunk_scales is None
    np.testing.assert_array_equal(port.chunk_data.numpy(), np.asarray(ref.chunk_data))
    assert port.nbytes() == port.chunk_data.numel() * 4 + port.chunk_ids.numel() * 4
