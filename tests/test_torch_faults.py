"""Faults of the port that a bad archive must meet with ``ContainerError``.

A top-k archive codes a token outside the top k as an escape: the id,
uniform over 2**uniform_bits(V) values. Decoded under other weights than
its encoder's, the stream is garbage, and an escape can decode to an id
at or above V. The JAX package clamps the next step's embedding gather
and fails later on a checksum; the port checks the id on the host and
raises ``ContainerError`` naming the chunk, through ``LLMCompressor``
(full and range decode) and through ``CompressionService``, whose other
jobs keep running. Before the check the CPU raised ``IndexError`` from
the embedding, and the card a device-side assert that poisoned the
process's CUDA context.

pred-base (6 layers, d=256, V=258, fp32) at random weights from a seed,
on the CPU; no JAX here.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

from repro_torch.configs.paper_predictors import PRED_BASE  # noqa: E402
from repro_torch.core import LLMCompressor, cdf  # noqa: E402
from repro_torch.core.compressor import ContainerError  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402

KW = dict(chunk_size=64, topk=48)
TOKENS = np.random.default_rng(7).integers(0, 256, 300).astype(np.int32)


@pytest.fixture(scope="module")
def archive():
    """(writer, other): pred-base from seeds 0 and 1, and a top-k 48
    v4 archive of TOKENS written by the first (5 chunks of 64)."""
    writer = ModelPredictor.random_init(PRED_BASE, seed=0, device="cpu")
    other = ModelPredictor.random_init(PRED_BASE, seed=1, device="cpu")
    blob, _ = LLMCompressor(writer, decode_batch=4, container_version=4,
                            **KW).compress(TOKENS)
    return writer, other, blob


def _chunk_named(err) -> int:
    m = re.match(r"chunk (\d+): an escape decoded to token id (\d+)",
                 str(err))
    assert m, str(err)
    assert int(m.group(2)) >= PRED_BASE.vocab_size
    assert "another model" in str(err)
    return int(m.group(1))


def test_the_writer_decodes_its_archive(archive):
    writer, _, blob = archive
    comp = LLMCompressor(writer, decode_batch=4, **KW)
    assert np.array_equal(comp.decompress(blob), TOKENS)
    svc = CompressionService(writer, slots=4, device="cpu", **KW)
    assert np.array_equal(svc.submit_decompress(blob).result(), TOKENS)


@pytest.mark.parametrize("path", ["decompress", "range"])
def test_mismatched_weights_raise_container_error_in_the_compressor(
        archive, path):
    _, other, blob = archive
    comp = LLMCompressor(other, decode_batch=4, **KW)
    with pytest.raises(ContainerError) as ei:
        if path == "decompress":
            comp.decompress(blob)
        else:
            comp.decompress_range(blob, 1, 5)
    chunk = _chunk_named(ei.value)
    assert chunk in (range(5) if path == "decompress" else range(1, 5))


def test_mismatched_weights_fail_the_job_and_the_service_serves_on(archive):
    _, other, blob = archive
    svc = CompressionService(other, slots=4, device="cpu", **KW)
    bad = svc.submit_decompress(blob)
    own, _ = svc.submit_compress(TOKENS).result()
    with pytest.raises(ContainerError) as ei:
        bad.result()
    assert _chunk_named(ei.value) in range(5)
    assert np.array_equal(svc.submit_decompress(own).result(), TOKENS)


def test_lookups_clamp_a_slot_past_the_cdf():
    """A slot at 2**precision (the peeked slots never reach it) resolves
    to the last symbol instead of gathering past the row."""
    lg = np.random.default_rng(3).normal(size=(3, 300)).astype(np.float32)
    slots = np.array([0, (1 << 16) - 1, 1 << 16], np.int32)
    ids, c, syms, starts, freqs = (cdf.to_numpy(a) for a in
                                   cdf.topk_cdf_lookup(lg, slots, 24, 16))
    assert syms.tolist()[1:] == [24, 24]
    assert np.array_equal(starts, c[np.arange(3), syms])
    fsyms, _, _ = (cdf.to_numpy(a) for a in
                   cdf.full_cdf_lookup(lg, slots, 16))
    assert fsyms.tolist()[1:] == [299, 299]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the gather that asserted)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mismatched_weights_raise_container_error_on_the_card(cuda):
    """On the card the id never reaches the embedding gather: the error
    is a ContainerError, and the CUDA context serves the next job."""
    writer = ModelPredictor.random_init(PRED_BASE, seed=0, device="cuda")
    other = ModelPredictor.random_init(PRED_BASE, seed=1, device="cuda")
    blob, _ = LLMCompressor(writer, decode_batch=4, container_version=4,
                            **KW).compress(TOKENS)
    with pytest.raises(ContainerError) as ei:
        LLMCompressor(other, decode_batch=4, **KW).decompress(blob)
    _chunk_named(ei.value)
    svc = CompressionService(other, slots=4, **KW)
    with pytest.raises(ContainerError):
        svc.submit_decompress(blob).result()
    torch.cuda.synchronize()
    back = CompressionService(writer, slots=4, **KW).submit_decompress(
        blob).result()
    assert np.array_equal(back, TOKENS)
