"""The port's zstd decoder (``utils/zstd.py``) against ``zstandard``'s
encoder, which this test host has and the card machine does not.

Frames at levels 1, 3, 9, 19 and 22, with and without the content checksum
and the content size, of inputs that make an encoder use each part of the
format: several blocks (more than 128 KB), all-equal bytes (RLE blocks),
random bytes (raw blocks), text with long matches (repeat offsets, repeated
tables), random float32 arrays (Huffman literals with few matches). The
decoded bytes must equal the input exactly. A bounded ``hypothesis`` property
covers short inputs; a flipped byte in a checksummed frame must raise, as
must a frame that needs a dictionary.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

zstandard = pytest.importorskip("zstandard")

from fs_uae_image_enhancer_project_tpu_torch.utils import zstd  # noqa: E402

LEVELS = (1, 3, 9, 19, 22)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads: the test runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _text(n: int) -> bytes:
    """Seeded source-like text: the same lines recur at varying distances,
    so matches reuse the last offsets."""
    rng = np.random.default_rng(3)
    words = [b"def", b"return", b"self", b"tensor", b"np.float32", b"offset", b"block",
             b"(x, y)", b"\n    ", b"=", b"+ 1", b"# comment", b"literal", b"sequence"]
    lines = [b" ".join(words[i] for i in rng.integers(0, len(words), 8)) + b"\n"
             for _ in range(64)]
    return b"".join(lines[i] for i in rng.integers(0, len(lines), n // 40))[:n]


def _inputs():
    rng = np.random.default_rng(0)
    floats = rng.standard_normal(12_000).astype(np.float32).tobytes()
    # a random block, then its pieces each after one zero byte: the second
    # block's literals are all zeros (RLE literals at level 19)
    noise = rng.integers(0, 256, 131_072, np.uint8).tobytes()
    pieces = b"".join(b"\0" + noise[i * 997:(i + 1) * 997] for i in range(100))
    return {
        "empty": b"",
        "one_byte": b"\x2a",
        "several_blocks": _text(300_000) + floats + bytes(rng.integers(0, 4, 20_000, np.uint8)),
        "all_equal": b"\x07" * 140_000,
        "random_bytes": rng.integers(0, 256, 30_000, np.uint8).tobytes(),
        "text": _text(40_000),
        "float32": floats,
        "small_float32": (rng.standard_normal(3000) * 1e-3).astype(np.float32).tobytes(),
        "one_literal_byte": noise + pieces,
    }


INPUTS = _inputs()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_zstd_decodes_zstandard_frames(level, checksum, content_size):
    """Exact bytes back for every input at this level and header layout."""
    enc = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                   write_content_size=content_size)
    for name, data in INPUTS.items():
        assert zstd.decompress(enc.compress(data)) == data, name


def test_zstd_frames_cover_each_part_of_the_format(monkeypatch):
    """The corpus above reaches raw, RLE and compressed blocks, every
    literals kind (raw, RLE, Huffman in 1 and 4 streams, treeless) and every
    sequence-table mode (predefined, RLE, FSE, repeat); so the exact-bytes
    test above exercises all of them."""
    seen = {"block": set(), "literals": set(), "modes": set()}
    real_frame, real_literals, real_table = zstd._frame, zstd._literals, zstd._sequence_table

    def literals(block, state):
        kind, fmt = block[0] & 3, (block[0] >> 2) & 3
        seen["literals"].add(("raw", "rle", "huffman", "treeless")[kind]
                             + ("" if kind < 2 else ("_1" if fmt == 0 else "_4")))
        if kind == 3:
            seen["literals"].add("treeless")
        return real_literals(block, state)

    def table(block, p, mode, name, state):
        seen["modes"].add(("predefined", "rle", "fse", "repeat")[mode])
        return real_table(block, p, mode, name, state)

    def frame(data, p):
        q = p + 1 + (0 if data[p] & 32 else 1) + (0, 1, 2, 4)[data[p] & 3] + (
            (1 if data[p] & 32 else 0, 2, 4, 8)[data[p] >> 6])
        while True:
            h = int.from_bytes(data[q:q + 3], "little")
            seen["block"].add(("raw", "rle", "compressed")[(h >> 1) & 3])
            q += 3 + (1 if (h >> 1) & 3 == 1 else h >> 3)
            if h & 1:
                break
        return real_frame(data, p)

    monkeypatch.setattr(zstd, "_frame", frame)
    monkeypatch.setattr(zstd, "_literals", literals)
    monkeypatch.setattr(zstd, "_sequence_table", table)
    for level in LEVELS:
        for data in INPUTS.values():
            assert zstd.decompress(zstandard.ZstdCompressor(level=level).compress(data)) == data
    assert seen["block"] == {"raw", "rle", "compressed"}
    assert {"raw", "rle", "huffman_1", "huffman_4", "treeless"} <= seen["literals"]
    assert seen["modes"] == {"predefined", "rle", "fse", "repeat"}


def test_zstd_concatenated_and_skippable_frames():
    a, b = INPUTS["text"][:5000], INPUTS["float32"][:7000]
    enc = zstandard.ZstdCompressor(level=3, write_checksum=True)
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    assert zstd.decompress(enc.compress(a) + skip + enc.compress(b)) == a + b


def test_zstd_xxh64_known_values():
    """XXH64 at seed 0 of the empty input (the published value) and of the
    corpus, through the frame checksum zstandard writes."""
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    for data in INPUTS.values():
        frame = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(data)
        assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")


def test_zstd_flipped_byte_in_a_checksummed_frame_raises():
    data = INPUTS["text"][:20_000]
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    rng = np.random.default_rng(5)
    for pos in rng.integers(6, len(frame), 12):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bytes(bad))
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd.decompress(b"\x00" + bytes(frame))
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(frame[:-7]))


def test_zstd_dictionary_frames_raise_naming_the_feature():
    frame = bytearray(zstandard.ZstdCompressor(level=1).compress(b"abc" * 100))
    # set the dictionary-ID flag to one byte and insert ID 7 after the
    # window descriptor
    frame[4] |= 1
    frame[6:6] = b"\x07"
    with pytest.raises(zstd.ZstdError, match="dictionar"):
        zstd.decompress(bytes(frame))


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(data=st.binary(max_size=3000), level=st.sampled_from(LEVELS),
       checksum=st.booleans(), repeat=st.integers(1, 4))
def test_zstd_property_round_trip(data, level, checksum, repeat):
    """Any short input, repeated to give the encoder matches, decodes to
    itself."""
    data = data * repeat
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data
