"""The port's zstd decoder (``csrc/tecozstd.cpp`` through
``utils/zstd.py``) against ``zstandard.decompress``, which is installed
here and used only as the oracle: levels -5 to 19, inputs of 0 B to 1 MB
(zeros, text, random bytes, float32 weights, a small alphabet, a periodic
stream), the content checksum on and off, frames with and without a
content size, several blocks across the window, concatenated and skippable
frames, hand-written frames for paths the compressor seldom takes, a
hypothesis case, and corrupt input that must raise."""

import struct

import numpy as np
import pytest
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from tecogan_tpu_torch.utils.zstd import ZstdError, decompress

torch.set_num_threads(1)


def _inputs():
    rng = np.random.RandomState(0)
    with open(__file__, "rb") as f:
        text = f.read()
    weights = (rng.randn(128 << 10) * 0.05).astype(np.float32).tobytes()  # 512 kB
    return {
        "empty": b"",
        "byte": b"x",
        "zeros": bytes(1 << 20),
        "text": (text * (300_000 // len(text) + 1))[:300_000],
        "random": rng.bytes(300_000),
        "weights": weights,
        # every kind at once, past several 128 kB blocks
        "mixed": text * 3 + rng.bytes(40_000) + bytes(70_000) + weights[:200_000],
        # few literal values: Huffman weights written directly (4 bits each)
        "alphabet": rng.randint(0, 12, 50_000).astype(np.uint8).tobytes(),
        # one sequence shape over and over: RLE-mode tables
        "periodic": b"".join(bytes([b]) + b"0123456789abcdefghijklmnopqrstuvwxyzABCD"
                             for b in rng.randint(0, 256, 3000)),
    }


INPUTS = _inputs()


def _compress(data, level, checksum=False, content_size=True):
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("name", list(INPUTS))
def test_levels_and_inputs_match_zstandard(name, level, checksum):
    data = INPUTS[name]
    frame = _compress(data, level, checksum)
    got = decompress(frame)
    assert got == zstandard.ZstdDecompressor().decompress(frame) == data


@pytest.mark.parametrize("size", [0, 200, 255, 256, 65_791, 65_792, 200_000])
def test_content_size_fields(size):
    """The frame content size takes 1, 2 (value - 256) or 4 bytes, or is
    absent (then a window descriptor and no single-segment flag)."""
    data = (b"tecogan " * (size // 8 + 1))[:size]
    for content_size in (True, False):
        frame = _compress(data, 3, content_size=content_size)
        assert decompress(frame) == data


def test_matches_across_blocks_and_the_window():
    """A random block repeated: its matches reach back across 128 kB block
    boundaries, in a frame with a window descriptor."""
    block = np.random.RandomState(1).bytes(150_000)
    data = block * 3
    for level in (1, 19):
        frame = zstandard.ZstdCompressor(level=level, write_content_size=False).compress(data)
        assert len(frame) < len(block) * 2  # the repeats became matches
        assert decompress(frame) == data


def test_concatenated_and_skippable_frames():
    a, b = INPUTS["text"][:5000], INPUTS["weights"][:70_000]
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    empty_skip = struct.pack("<II", 0x184D2A5F, 0)
    stream = _compress(a, 3) + skip + _compress(b, 1, checksum=True) + empty_skip + _compress(a, -5)
    assert decompress(stream) == a + b + a
    assert decompress(skip) == b""


@settings(max_examples=40, deadline=None)
@given(data=st.binary(min_size=0, max_size=3000),
       repeat=st.integers(min_value=1, max_value=40),
       level=st.sampled_from([-3, 1, 5, 12, 19]),
       checksum=st.booleans())
def test_hypothesis_round_trips(data, repeat, level, checksum):
    payload = data * repeat
    assert decompress(_compress(payload, level, checksum)) == payload


def test_corrupt_input_raises():
    data = INPUTS["mixed"][:200_000]
    frame = bytearray(_compress(data, 3, checksum=True))
    with pytest.raises(ZstdError, match="magic"):
        decompress(b"\x00" * 16)
    with pytest.raises(ZstdError):
        decompress(b"")
    for cut in (3, 6, 20, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ZstdError):
            decompress(bytes(frame[:cut]))
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    with pytest.raises(ZstdError, match="checksum"):
        decompress(bytes(bad))
    # Byte flips through the frame: each must raise (a flip the decoder
    # passes changes the content, and the checksum catches it).
    rng = np.random.RandomState(2)
    for pos in rng.randint(6, len(frame) - 4, size=60):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.randint(8))
        with pytest.raises(ZstdError):
            decompress(bytes(bad))
    # A reserved block type (3) in a raw frame's first block header.
    raw = bytearray(_compress(INPUTS["random"][:1000], 1))
    header = 7  # magic, descriptor, a 2-byte content size
    raw[header] |= 0b110
    with pytest.raises(ZstdError, match="reserved block type"):
        decompress(bytes(raw))


def test_dictionary_and_declared_size_are_enforced():
    samples = [INPUTS["text"][i:i + 400] for i in range(0, 40_000, 400)]
    dictionary = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(INPUTS["text"][:1000])
    with pytest.raises(ZstdError, match="dictionary"):
        decompress(frame)
    # A content size smaller than the content: the decoder stops there.
    data = INPUTS["text"][:1000]
    frame = bytearray(_compress(data, 3))
    assert frame[4] >> 6 == 1  # a 2-byte content size: value - 256
    struct.pack_into("<H", frame, 5, 900 - 256)
    with pytest.raises(ZstdError, match="content size"):
        decompress(bytes(frame))


def _frame(content_size, block):
    """One single-segment frame (4-byte content size) around one last
    compressed block, written by hand (RFC 8878 3.1.1)."""
    return (struct.pack("<IB", 0xFD2FB528, 0b1010_0000) + struct.pack("<I", content_size)
            + (1 | 2 << 1 | len(block) << 3).to_bytes(3, "little") + block)


@pytest.mark.parametrize("case", ["rle_literals", "three_byte_sequence_count"])
def test_hand_written_frames_match_zstandard(case):
    """Paths the compressor seldom takes: RLE literals, and 0x7F00
    sequences (the count's 3-byte form) over RLE-mode tables whose codes
    read no bits: each sequence one literal, then a match of 3 at offset 1."""
    if case == "rle_literals":
        block = bytes([1 | 0 << 2 | 10 << 3]) + b"a" + b"\x00"  # 10 x "a", no sequence
        frame, want = _frame(10, block), b"a" * 10
    else:
        n = 0x7F00
        literals = bytes([1 | 3 << 2 | (n & 15) << 4, (n >> 4) & 0xFF, n >> 12]) + b"a"
        sequences = b"\xff\x00\x00" + bytes([1 << 6 | 1 << 4 | 1 << 2]) + b"\x01\x00\x00"
        frame, want = _frame(4 * n, literals + sequences + b"\x01"), b"a" * (4 * n)
    assert zstandard.ZstdDecompressor().decompress(frame) == want
    assert decompress(frame) == want
