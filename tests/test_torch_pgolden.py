"""The committed JAX archives of this slice through the port's plain passes on
the CPU: the crp archive of the 1 MiB corpus (S=512, T=2048, full-size LZP
tables) decodes to the committed corpus and the port's ``crp e -b1 -l512``
writes it again, byte for byte; the 1 MiB crx archives written under
``CPX_X_FINDER=scan`` decode (a decoder knows no finder).  The 8 MiB crp
archive and the scan-route re-encodes (KSx's plain version takes minutes a
MiB here) are reproduced on a card by chip_smoke.py."""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from comprox_tpu_torch.cli import main as cli
from comprox_tpu_torch.codec import container as con

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
META = json.loads((DATA / "torch_golden.json").read_text())


def corpus_1mib():
    """The corpus, decoded from the crf archive (host-side LZ copies)."""
    out = io.BytesIO()
    con.decode_stream(io.BytesIO((DATA / "crf_flex_1MiB_S512.cpx").read_bytes()),
                      out, "cpu")
    return np.frombuffer(out.getvalue(), np.uint8)


def test_crp_golden_1mib_is_reproduced():
    m = META["crp_1MiB_S512.cpx"]
    data = corpus_1mib()
    assert hashlib.sha256(data.tobytes()).hexdigest() == m["input_sha256"]
    cp = cli.make_params("crp", {"lanes": 512, "block_mb": 1})
    buf = io.BytesIO()
    con.encode_stream(data, buf, cp, "cpu")
    assert len(buf.getvalue()) == m["archive_bytes"]
    assert buf.getvalue() == (DATA / "crp_1MiB_S512.cpx").read_bytes()


@pytest.mark.parametrize("name", ["crp_1MiB_S512.cpx", "crx_scan_flex_1MiB_S512.cpx",
                                  "crx_scan_f0_1MiB_S512.cpx"])
def test_golden_1mib_decodes_to_the_committed_corpus(name):
    m = META[name]
    out = io.BytesIO()
    con.decode_stream(io.BytesIO((DATA / name).read_bytes()), out, "cpu")
    assert len(out.getvalue()) == m["input_bytes"]
    assert hashlib.sha256(out.getvalue()).hexdigest() == m["input_sha256"]


def test_crp_golden_sizes_are_the_recorded_ratios():
    """0.6721 bpb on the 8 MiB corpus is the ratio the reference round
    recorded for crp; the port writes these bytes, so the ratio is its own."""
    m8, m1 = META["crp_8MiB_S512.cpx"], META["crp_1MiB_S512.cpx"]
    assert round(m8["archive_bytes"] * 8 / m8["input_bytes"], 4) == 0.6721
    assert m1["archive_bytes"] == 181272
    assert (DATA / "crp_8MiB_S512.cpx").stat().st_size == m8["archive_bytes"]
