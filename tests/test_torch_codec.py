"""The port's wire codec against the JAX package's.

For every structured value and numpy array the port's ``encode`` gives
the JAX codec's meta and segments byte for byte, and each package decodes
the other's bytes.  Tensors (the port's own tag) round-trip in fp32, bf16
and int64, from any layout; the restricted unpickler refuses gadgets and
every ``torch`` global.
"""

import os
import pickle

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from parsec_tpu.comm import codec as jcodec
from parsec_tpu_torch.comm import codec
from parsec_tpu_torch.core.params import params


def _bytes(segs):
    return [bytes(memoryview(s).cast("B")) for s in segs]


def _same_encoding(value):
    meta, segs = codec.encode(value)
    jmeta, jsegs = jcodec.encode(value)
    assert bytes(meta) == bytes(jmeta)
    assert _bytes(segs) == _bytes(jsegs)
    return meta, segs


def _seeded_values(seed):
    rng = np.random.default_rng(seed)
    return {
        "tp": int(rng.integers(1, 1 << 40)), "tc": 0,
        "locals": {"m": int(rng.integers(-9, 9)), "k": -2},
        "outputs": [(0, 1, 3, 7, rng.standard_normal(6).astype(np.float32))],
        "ranks": [int(x) for x in rng.permutation(5)], "tree": "binomial",
        "ok": True, "no": False, "none": None,
        "f": float(rng.standard_normal()), "blob": b"xy",
        "big": bytes(rng.integers(0, 255, 4096, dtype=np.uint8)),
        "nested": ({"a": [1, (2.5, "s")]}, []),
        "scalars": [np.int64(7), np.float32(1.5), np.bool_(True)],
        "small_bytes": bytearray(b"z" * 511), "big_bytes": b"q" * 512,
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_structured_values_encode_byte_identical(seed):
    value = _seeded_values(seed)
    meta, segs = _same_encoding(value)
    got = codec.decode_with_segments(meta, segs)
    assert got["locals"] == value["locals"] and got["ranks"] == value["ranks"]
    assert got["big"] == value["big"] and got["none"] is None
    np.testing.assert_array_equal(got["outputs"][0][4],
                                  value["outputs"][0][4])


ARRAYS = [
    np.arange(24, dtype=np.float32).reshape(4, 6),
    np.arange(24, dtype=np.float64)[::2],                   # strided
    np.arange(24, dtype=np.int32).reshape(4, 6)[:, 1:3],    # inner slice
    np.arange(24, dtype=np.int64).reshape(2, 3, 4).transpose(2, 0, 1),
    np.empty((0, 5), np.int32),                             # zero-size
    np.array(3.5),                                          # 0-d
    np.arange(6, dtype=">i4"),                              # big-endian
    np.arange(6, dtype=np.uint8), np.arange(6, dtype=np.int16),
    np.arange(6, dtype=np.float16), np.array([True, False]),
    np.arange(4, dtype=np.complex64),
]


@pytest.mark.parametrize("i", range(len(ARRAYS)))
def test_numpy_arrays_encode_byte_identical(i):
    arr = ARRAYS[i]
    meta, segs = _same_encoding({"a": arr, "n": 1})
    got = jcodec.decode_with_segments(meta, segs)["a"]
    assert got.shape == arr.shape and got.dtype == arr.dtype
    np.testing.assert_array_equal(got, arr)


def test_each_package_decodes_the_others_bytes():
    value = dict(_seeded_values(3), arrays=ARRAYS)
    for enc, dec in ((codec, jcodec), (jcodec, codec)):
        meta, segs = enc.encode(value)
        got = dec.decode_with_segments(bytes(meta), segs)
        assert got["tree"] == "binomial" and got["scalars"] == [7, 1.5, True]
        for a, b in zip(got["arrays"], ARRAYS):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_a_jax_array_decodes_as_numpy_here():
    import jax.numpy as jnp
    meta, segs = jcodec.encode({"x": jnp.arange(5, dtype=jnp.float32)})
    got = codec.decode_with_segments(bytes(meta), segs)["x"]
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, np.arange(5, dtype=np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64])
def test_tensors_roundtrip(dtype):
    g = torch.Generator().manual_seed(0)
    base = (torch.randn(6, 10, generator=g) * 100).to(dtype)
    for t in (base, base[:, 2:7], base.T, base[:0], base[1, 1]):
        meta, segs = codec.encode({"t": t})
        assert len(segs) == (1 if t.numel() else 0)
        got = codec.decode_with_segments(meta, segs)["t"]
        assert got.dtype == dtype and got.shape == t.shape
        assert got.device.type == "cpu"
        assert torch.equal(got, t)
    # the decoded tensor owns its bytes
    got = codec.roundtrip(base)
    base.zero_()
    assert got.abs().sum() > 0


def test_a_torch_object_other_than_a_tensor_is_refused_at_the_sender():
    with pytest.raises(TypeError, match="torch"):
        codec.encode({"dtype": torch.float32})


def test_pickle_fallback_is_gated_by_its_param():
    saved = params.get("comm_codec_pickle_fallback")
    assert codec.roundtrip(slice(1, 5)) == slice(1, 5)
    assert codec.roundtrip(1 << 100) == 1 << 100
    params.set("comm_codec_pickle_fallback", False)
    try:
        with pytest.raises(TypeError):
            codec.encode(slice(1, 5))
    finally:
        params.set("comm_codec_pickle_fallback", saved)


def test_restricted_unpickler_refuses_gadgets_and_torch():
    with pytest.raises(pickle.UnpicklingError):
        codec.restricted_loads(pickle.dumps(os.system))
    for obj in (torch.float32, torch.zeros(2), torch.device("cpu")):
        with pytest.raises(pickle.UnpicklingError):
            codec.restricted_loads(pickle.dumps(obj))
    # numpy revival stays allowed (the fallback's legitimate cargo)
    np.testing.assert_array_equal(
        codec.restricted_loads(pickle.dumps(np.arange(3))), np.arange(3))


def test_a_corrupt_tensor_header_is_an_error():
    meta, segs = codec.encode(torch.zeros(3))
    bad = bytearray(meta)
    bad[2:2 + len("float32")] = b"os_syst"
    with pytest.raises(ValueError):
        codec.decode_with_segments(bad, segs)


_leaf = (st.none() | st.booleans()
         | st.integers(min_value=-(1 << 63), max_value=(1 << 63) - 1)
         | st.floats(allow_nan=False) | st.text(max_size=8)
         | st.binary(max_size=600))
_values = st.recursive(
    _leaf, lambda kids: st.lists(kids, max_size=4)
    | st.tuples(kids, kids)
    | st.dictionaries(st.text(max_size=4) | st.integers(), kids, max_size=4),
    max_leaves=12)


@settings(max_examples=60, deadline=None, database=None)
@given(_values)
def test_roundtrip_and_parity_property(value):
    meta, segs = _same_encoding(value)
    assert codec.decode_with_segments(meta, segs) == value
