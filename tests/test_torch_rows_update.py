"""K5's plain version and its wrapper on CPU tensors against the JAX
package's row patch, `jnp.asarray(d).at[p].set(r)`.

Compared as bytes (exact: a scatter copies, so NaN payloads and the sign
of zero must survive), over int8, int32, float32 and uint32 leaves (the
latter as the int32 views the port keeps), leaf shapes [n], [n, A] and
[n, A, B], and m = 1, 3 padded to 4 with a duplicated last index (the
JAX package's power-of-two padding) and n (every row, permuted).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch.ir.carry import to_tensor
from gatekeeper_tpu_torch.kernels.rows_update import (
    rows_update,
    rows_update_plain,
)

from .torch_kernel_cases import (
    K5_DTYPES,
    K5_MS,
    K5_N,
    K5_SHAPES,
    k5_case,
    k5_random,
)

@pytest.mark.parametrize("m", K5_MS)
@pytest.mark.parametrize("shape", K5_SHAPES)
@pytest.mark.parametrize("dtype", K5_DTYPES)
def test_plain_and_cpu_wrapper_equal_jax(dtype, shape, m):
    dst, pos, new = k5_case(dtype, shape, m,
                            zlib.crc32(repr((dtype, shape, m)).encode()))
    want = np.asarray(jnp.asarray(dst).at[pos].set(new))
    assert want.dtype == dst.dtype

    plain = to_tensor(dst.copy(), "cpu")
    rows_update_plain([plain], torch.from_numpy(pos.astype(np.int64)),
                      [to_tensor(new, "cpu")])
    assert plain.numpy().tobytes() == want.tobytes()

    wrapped = to_tensor(dst.copy(), "cpu")
    rows_update([wrapped], pos, [new])
    assert wrapped.numpy().tobytes() == want.tobytes()


def test_cpu_wrapper_patches_every_leaf_of_a_kind():
    """One call patches leaves of several dtypes and row shapes, as the
    driver patches a kind's feature leaves; the host leaf's tensor is
    a view, so the patch is visible through the numpy array."""
    rng = np.random.default_rng(5)
    leaves = [k5_random(rng, (K5_N,) + s[1:], d)
              for d, s in zip(K5_DTYPES, K5_SHAPES + [(K5_N, 2)])]
    pos = np.array([3, 0, 36, 17], dtype=np.int32)
    rows = [k5_random(rng, (4,) + a.shape[1:], str(a.dtype))
            for a in leaves]
    want = [np.asarray(jnp.asarray(a).at[pos].set(r))
            for a, r in zip(leaves, rows)]
    tensors = [to_tensor(a, "cpu") for a in leaves]
    rows_update(tensors, pos, rows)
    for a, t, w in zip(leaves, tensors, want):
        assert a.tobytes() == w.tobytes()
        assert t.numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("bad", ["row_shape", "item_size", "position"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    dst = to_tensor(np.zeros((8, 4), dtype=np.int32), "cpu")
    pos = np.array([1, 2], dtype=np.int32)
    rows = np.ones((2, 4), dtype=np.int32)
    if bad == "row_shape":
        rows = np.ones((2, 5), dtype=np.int32)
    elif bad == "item_size":
        rows = np.ones((2, 4), dtype=np.int8)
    else:
        pos = np.array([1, 8], dtype=np.int32)
    with pytest.raises(ValueError):
        rows_update([dst], pos, [rows])
