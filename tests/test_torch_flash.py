"""The port's prefill attention against the JAX package's.

On the CPU ``repro_torch.kernels.ops.flash_attention`` runs the CUDA
kernel's plain PyTorch version (``kernels/ref.py``). It is held here
against the Pallas kernel as ``test_kernels.py`` runs it
(``flash_attention(..., interpret=True)``, the kernel's own contract) and
against ``attention_masked``, the attention the JAX model actually runs
(``models/layers.py``, in its (B, S, H, hd) layout). Inputs are made
with numpy from a seed and handed to both.

Tolerances, as ``test_kernels.py:32-48`` sets them: atol 1e-5 in fp32
(the two packages sum the scores and the weighted values in other
orders) and 3e-2 in bf16 (inputs and output rounded to bf16, 8 bits of
mantissa). Ragged lengths that are no block multiple go against
``attention_masked`` only: the Pallas wrapper asserts block multiples.

The CUDA kernel itself is held against the plain version on a card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro.models.layers import attention_masked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

_DT = {"float32": (jnp.float32, torch.float32, 1e-5),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(B, H, K, S, hd, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.normal(size=(B, H, S, hd)).astype(np.float32),
            rng.normal(size=(B, K, Sk, hd)).astype(np.float32),
            rng.normal(size=(B, K, Sk, hd)).astype(np.float32))


def _port(q, k, v, tdt, causal, window):
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    return ops.flash_attention(t(q), t(k), t(v), causal,
                               window).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_kernel(causal, window, G, hd, dtype):
    jdt, tdt, tol = _DT[dtype]
    q, k, v = _inputs(1, 2 * G, 2, 64, hd, seed=hd + G)
    want = j_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                   jnp.asarray(v, jdt), causal=causal, window=window,
                   block_q=32, block_k=32, interpret=True)
    got = _port(q, k, v, tdt, causal, window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 50])
def test_plain_matches_attention_masked(S, causal, window, G, hd, dtype):
    """S = 50 is no block multiple: the kernel masks the ragged tile."""
    jdt, tdt, tol = _DT[dtype]
    q, k, v = _inputs(2, 2 * G, 2, S, hd, seed=S + hd + G)
    tr = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3), jdt)  # noqa: E731
    want = attention_masked(tr(q), tr(k), tr(v), causal=causal,
                            window=window, q_chunk=32)
    got = _port(q, k, v, tdt, causal, window)
    np.testing.assert_allclose(
        got, np.asarray(want, np.float32).transpose(0, 2, 1, 3), atol=tol)


def test_plain_takes_sq_unequal_sk():
    """Any Sq and Sk: non-causal queries over a longer key sequence."""
    q, k, v = _inputs(1, 4, 2, 24, 32, seed=3, Sk=40)
    tr = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    want = attention_masked(tr(q), tr(k), tr(v), causal=False)
    got = _port(q, k, v, torch.float32, False, None)
    np.testing.assert_allclose(
        got, np.asarray(want).transpose(0, 2, 1, 3), atol=1e-5)


def test_row_without_visible_keys_is_zero_not_nan():
    """A query that sees no key (only possible with Sq > Sk under a
    window) gives 0, with the -1e30 mask value and the 1e-30 floor."""
    q, k, v = _inputs(1, 2, 1, 40, 16, seed=4, Sk=8)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    out = ref.flash_attention(t(q), t(k), t(v), False, 4)
    assert torch.isfinite(out).all()
    assert (out[:, :, 11:] == 0).all() and (out[:, :, :11] != 0).any()


def test_prefill_attention_keeps_the_model_layout():
    """``layers.prefill_attention`` takes and returns (B, S, heads, hd)."""
    q, k, v = _inputs(2, 4, 2, 20, 32, seed=5)
    tr = lambda a: torch.from_numpy(a.transpose(0, 2, 1, 3).copy())  # noqa
    got = layers.prefill_attention(tr(q), tr(k), tr(v), window=8)
    want = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), True, 8)
    assert got.shape == (2, 20, 4, 32)
    assert torch.equal(got, want.transpose(1, 2))
