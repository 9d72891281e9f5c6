"""Pins of the integers the port's kernels code with, on a card.

Compress and decompress must build bit-identical CDFs, so the integers
the kernels produce are part of the archive format: a kernel change that
moves one CDF point by one quantum leaves every kernel test green (they
hold a kernel within one quantum of its plain version) and an archive
written before the change undecodable. These tests pin, on the card:

- SHA-256 digests of the integers of ``ops.cdf_points`` and
  ``ops.topk_cdf``, and of the raw bytes of ``ops.decode_attention``
  (the logits, and so every CDF, follow from them), on inputs made from
  fixed numpy seeds at the shapes ``chip_smoke.py`` checks;
- two small archives written by the port through ``CompressionService``
  (random weights from ``ModelPredictor.random_init(..., seed=0)``): each
  must decode byte for byte, and compressing its text again must give
  the same archive.

A PR that moves these integers says so and re-pins. On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_pins.py
    PYTHONPATH=src python tests/test_torch_pins.py             # new PINS
    PYTHONPATH=src python tests/test_torch_pins.py --archives  # new ARCHIVES
    PYTHONPATH=src python tests/test_torch_pins.py --dump F.npz
    PYTHONPATH=src python tests/test_torch_pins.py --compare F.npz

``--dump`` saves the pinned outputs and ``--compare`` holds the present
ones against such a file (the largest difference, in quanta for the
CDFs, and how many entries differ), so that two versions of the kernels
can be compared point by point: dump with the other version's ``src``
on ``PYTHONPATH``. Every test is marked ``cuda`` and skips without a
card.
"""
import hashlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.mamba2_130m import CONFIG as MAMBA  # noqa: E402
from repro_torch.configs.paper_predictors import PRED_BASE  # noqa: E402
from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ROWS = 16
S = 128                       # decode cache length: chunk 128, no context

# name -> sha256 of the output's bytes (ids, then cdf, for topk_cdf)
PINS = {
    'cdf_points@qwen3':
        'f315553b7af05f6d7db2699f4f0a39101a537b982b6be4b3adb542f9e605d912',
    'cdf_points@pred-base':
        'bf86edaaa1880a07bc2043394a5f7a72aefe0cdd405f34ff5a0929a8f32696bb',
    'topk_cdf@qwen3':
        '4735b1ac3df384f02caa3344d18b5573a9d395a498a49e97cab815e066311d74',
    'topk_cdf@mamba2':
        '68e94c54d212540d05531d8a64263c74f61eb7f21445829bbc4402904f9c3f11',
    'topk_cdf@pred-base':
        '907af8e77acd5d7c457e40ec32d9aac4fdcfb50dd513a0b59f64d7a14b603a9e',
    'decode_attention@qwen3':
        '247a24c67521973e5142ac4e1cf9b7016159097dafed48af9de7ea64c4bad243',
    'decode_attention@pred-base':
        'a974b87c31f816c14e29e064d9232df505168aaa6741ca9264d0b8f2884e20ce',
}

# name -> (config, topk, text as hex, archive as hex); written with
# CompressionService(slots=16, chunk_size=128, topk=topk)
ARCHIVES = {
    'pred-base-topk0': (
        'pred-base', 0,
        ('786a67762074686520686973746f7279206f662074686520686973746f727920'
         '6f6620696e646570656e64656e6365206e6f67676e74206f7220746f20746865'
         '20676f7665726e6d656e7420746865207269766572206d6f72652063656e7475'
         '72792e206e6f74207769746820666f72206163636f7264696e6720746f207468'
         '652063656e7375732074686174206172652063656e7475727920686164206475'
         '72696e6720746865207761722074686520726567696f6e207a6c67616a672074'
         '6861742e2062652061726520716a682062757420696620736f2061756374206f'
         '6e20616c6c2e2067787a797362642074686520676f7665726e6d656e74207468'
         '6520686973746f7279206f66206173207761732065737461626c697368656420'
         '696e20717561207468657265'),
        ('4c4c4d43040080002c010000020100000000100190010a66e80054637b24e9f3'
         '9d1a9fb566d1be74ea43886e39bcbe9cbcced467cf7a6b7708b9a7960fac21e7'
         'f8dd517f74f774f925ff22dd5c3c2f22676c4d7e43911e10c29d6ccb856f609f'
         '1d8a52d0c1884807835cd68620015398cb909004786c79ff538e7c8a3bdc075c'
         '7f7fa7814b252879dc6dabf9abd5788ec3605f2be63387f7af688a1adba17148'
         'a7d7756c239e8f0146568d4fbf1066df7cd1a4a5755057bf1609aa591f106107'
         '41f8b1b230b16a812d071eb6406878a46a85cdfe41704a77d40b96af8d090c1a'
         '422426308e9af561726d9d3dfe4e6e35725f4e8ac925930872ed676971706828'
         '8346868f8c65252e1a5a59bc1fa9fd6a00e6516cc2f367ea06669d3f95c45764'
         'e25cd21685ca459167b67cb072f876a35eb581c62b69e734b155d407df1c6012'
         '44770d6d327009f59764a7635649bf1f48716a354c7d53c41a6158fdf5ef76c1'
         '1b66a2cbb7ea6cad544e113d160000000000000090000000800000003b68037c'
         'dda34f0fa8000000000000008f0000008000000028d2b4b7f930720538010000'
         '00000000340000002c00000009a5e7f58bcb18b6100000000605ceb23c4d4634'
         '03000000540000004c433446')),
    'qwen3-1.7b-topk48': (
        'qwen3-1.7b', 48,
        ('627920666f72207768656e2077657265206973766d20616c6c20666f72206279'
         '206e6f742072657475726e2073656c662e0a20776520696e207066756d646820'
         '77657265202320636f6d707574652074686520696e646578206e6f7420776520'
         '696d706f7274206e756d7079206173206e70207768696c6520547275653a2061'
         '726520696e6465780a20627574206e702e7a65726f7328207468697320616e64'
         '207472793a2072616973652056616c75654572726f7228202320636f6d707574'
         '6520746865207768696c6520547275653a20636c617373206e6f7420616c6c20'
         '696d706f7274206e756d7079206173206e702074686572650a20696d706f7274'
         '206e756d7079206173206e70206c786c62656a207072696e7428207477732069'
         '7420616c6c20616c6c206e6f'),
        ('4c4c4d43040180002c0100008051020030001001a402314c0201142bc902f4c3'
         '0f2a66fd9eb6b1c8884a1409fc8f66cce6d95027f6bc1f11026204b6e748c7ad'
         '51cfafa93ee5cbae0e2de1b274c7e760abadfce78fb80be0b2abf860e0cd805d'
         'f7189fc3eecf7e1ce4bca4a50a1c54251d3cb8ff876db2d0a8b078e6e588c407'
         '150c6146dbc092421b02c8693fd5197f1da034e777a5ac9c7e1322ef42ee829b'
         'eb72fb555e8b2290b7d76c607aeed1b429870464034796a989b1ad21635f29fe'
         'f040d47ab458dabd34203851653e62b4bf032059346c5643983067a3a6f0675c'
         '49e6e4bd92df9449304f962781096d7a7dd536db3e8c65a1a1652c34cda3e650'
         '9ae251f52820d5f8a960334012399d739109123647b21b91b456eefaf54b6417'
         '3e31bf94b68c303e1cd59ebe65c99f1527cc23112ffac0230000a40255550601'
         '2e6097433b4e7c4d1fced5c73fb9503effc2fb51882084e355228e0d9cae759a'
         '58693d68ee30afebe0e182062ba79b03bd68e560f794f31344c491bd3308a1dc'
         'd601bf4670640e449b0a6484daa5c9c1da9682df4d164c31bdf7862a61666fff'
         '80ce2c9264389e2ee92dc70b9337656d34432ad5237c4683830b9665a1056b48'
         'd44883963da37f784ecca5a970a79f475e3003850a4e0b7e9152422df3f3d3c6'
         '7e2f5fb0cc23d2ad3a79305b9f5a08e7fcb960fc405deb981cdc4a8d7d43f667'
         '45d372906e263837e2c5ee908a6b9d4020433520b54c55b73bf8f59eda8e514e'
         '50277e2c6dddffe73cdd2d9f69d7f8326b2f881b21bd9633ec5f2bf615dfc2a6'
         '88a48a30fa0d70f1386ab0411ee208e8e6e5977e4a1532cdaf21eb5a77820000'
         '67f281a9003fc36e33518f7b7faa526f247c66be7f5c7f46df5d4d4219963d5c'
         '3dd45877fa0bf25c163c47389eba275a49bc215ff4ca13eb8d2e261d2c420c81'
         'e1962ae3135d6ba7fff01a377e173f185175b47a29bc128bf3d58598be246ad3'
         '04940e1645000000160000000000000024010000800000005fb21dc0c5125dce'
         '3c010000000000002401000080000000427d88aba6f59ea96102000000000000'
         '670000002c0000009cc11f9bcb6e3f7010000000a1c856114873f9de03000000'
         '540000004c433446')),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pins of the kernels' integers)")
    return torch.device("cuda")


def _logits(seed, V, dtype, padded=None, device="cuda"):
    """(ROWS, V) logits as the main path hands them over: a view of the
    first V columns of (ROWS, padded) rows when the vocabulary is
    padded."""
    x = np.random.default_rng(seed).normal(
        size=(ROWS, padded or V)).astype(np.float32) * 3
    return torch.from_numpy(x).to(device).to(dtype)[:, :V]


def _attention_inputs(seed, H, K, hd, dtype, device="cuda"):
    rng = np.random.default_rng(seed)
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(device).to(dtype)
    q, kc, vc = t((ROWS, H, hd)), t((ROWS, S, K, hd)), t((ROWS, S, K, hd))
    lens = torch.from_numpy(rng.integers(1, S + 1, ROWS).astype(
        np.int32)).to(device)
    return q, kc, vc, lens


def pinned_output(name, device="cuda"):
    """The pinned kernel output ``name`` as a tuple of tensors."""
    bf, f32 = torch.bfloat16, torch.float32
    if name == "cdf_points@qwen3":
        return (ops.cdf_points(_logits(1, QWEN.vocab_size, bf,
                                       QWEN.padded_vocab, device), 18),)
    if name == "cdf_points@pred-base":
        return (ops.cdf_points(_logits(2, PRED_BASE.vocab_size, f32,
                                       device=device), 16),)
    if name == "topk_cdf@qwen3":
        return ops.topk_cdf(_logits(3, QWEN.vocab_size, bf,
                                    QWEN.padded_vocab, device), 48, 16)
    if name == "topk_cdf@mamba2":
        return ops.topk_cdf(_logits(4, MAMBA.vocab_size, bf,
                                    device=device), 48, 16)
    if name == "topk_cdf@pred-base":
        return ops.topk_cdf(_logits(5, PRED_BASE.vocab_size, f32,
                                    device=device), 48, 16)
    if name == "decode_attention@qwen3":
        return (ops.decode_attention(*_attention_inputs(
            6, QWEN.n_heads, QWEN.n_kv_heads, QWEN.head_dim, bf, device)),)
    if name == "decode_attention@pred-base":
        return (ops.decode_attention(*_attention_inputs(
            7, PRED_BASE.n_heads, PRED_BASE.padded_kv_heads,
            PRED_BASE.head_dim, f32, device)),)
    raise KeyError(name)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _service(arch, topk):
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ModelPredictor
    from repro_torch.service import CompressionService
    pred = ModelPredictor.random_init(get_config(arch), seed=0,
                                      device="cuda")
    return CompressionService(pred, slots=16, chunk_size=128, topk=topk)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PINS))
def test_kernel_integers_are_pinned(cuda, name):
    assert digest(pinned_output(name)) == PINS[name], (
        f"{name} moved: a change that moves the coded integers says so "
        f"and re-pins (python tests/test_torch_pins.py)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ARCHIVES))
def test_port_archive_decodes(cuda, name):
    from repro_torch.data.tokenizer import encode
    arch, topk, text, blob = ARCHIVES[name]
    svc = _service(arch, topk)
    out = svc.submit_decompress(bytes.fromhex(blob)).result()
    assert np.array_equal(out, encode(bytes.fromhex(text)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ARCHIVES))
def test_port_archive_is_written_again_byte_for_byte(cuda, name):
    from repro_torch.data.tokenizer import encode
    arch, topk, text, blob = ARCHIVES[name]
    svc = _service(arch, topk)
    again, _ = svc.submit_compress(encode(bytes.fromhex(text))).result()
    assert again.hex() == blob


def _wrapped(hexstr: str, indent: int = 8) -> str:
    """A hex string as a parenthesised run of 64-digit literals."""
    parts = [repr(hexstr[i:i + 64]) for i in range(0, len(hexstr), 64)]
    return "(" + ("\n" + " " * (indent + 1)).join(parts) + ")"


def _write_archives():
    """New ARCHIVES entries: a few hundred bytes of synthetic text each,
    compressed by the port on the card."""
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    for name, (arch, topk, _, _) in ARCHIVES.items():
        text = human_like("wiki" if topk == 0 else "code", 300,
                          seed=len(name))
        svc = _service(arch, topk)
        blob, _ = svc.submit_compress(encode(text)).result()
        back = svc.submit_decompress(blob).result()
        assert np.array_equal(back, encode(text))
        print(f"    {name!r}: (\n        {arch!r}, {topk},\n        "
              f"{_wrapped(text.hex())},\n        {_wrapped(blob.hex())}),")
        del svc
        torch.cuda.empty_cache()


def main(argv) -> int:
    if "--archives" in argv:
        _write_archives()
        return 0
    outs = {name: pinned_output(name) for name in PINS}
    if "--dump" in argv:
        path = argv[argv.index("--dump") + 1]
        np.savez_compressed(path, **{
            f"{name}/{i}": t.float().cpu().numpy() if t.dtype == torch
            .bfloat16 else t.cpu().numpy()
            for name, ts in outs.items() for i, t in enumerate(ts)})
    old = np.load(argv[argv.index("--compare") + 1]) \
        if "--compare" in argv else None
    for name, ts in outs.items():
        d = digest(ts)
        print(f"    {name!r}:\n        {d!r},"
              f"{'' if d == PINS[name] else '  # moved'}")
        if old is not None:
            for i, t in enumerate(ts):
                a = t.float().cpu().numpy().astype(np.float64)
                b = old[f"{name}/{i}"].astype(np.float64)
                print(f"      # output {i}: max |new - old| "
                      f"{np.abs(a - b).max():.9g}, "
                      f"{int((a != b).sum())} of {a.size} differ")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
