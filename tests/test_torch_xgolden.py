"""The committed JAX crx archives of the 1 MiB corpus (S=512, T=2048, full
tables) through the port's plain passes on the CPU: each decodes to the
committed corpus, and the port's ``crx e -b1 -l512`` (flexible and ``-f0``)
writes each archive again, byte for byte.  The 8 MiB archive is reproduced
on a card by chip_smoke.py."""

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


@pytest.mark.parametrize("parse", ["flex", "f0"])
def test_crx_golden_1mib_is_reproduced(parse):
    name = f"crx_{parse}_1MiB_S512.cpx"
    m = META[name]
    data = corpus_1mib()
    assert hashlib.sha256(data.tobytes()).hexdigest() == m["input_sha256"]
    cp = cli.make_params("crx", {"lanes": 512, "block_mb": 1,
                                 "flexible": parse == "flex"})
    buf = io.BytesIO()
    con.encode_stream(data, buf, cp, "cpu")
    assert len(buf.getvalue()) == m["archive_bytes"]
    assert buf.getvalue() == (DATA / name).read_bytes()


def test_crx_golden_1mib_decodes_to_the_committed_corpus():
    m = META["crx_flex_1MiB_S512.cpx"]
    out = io.BytesIO()
    con.decode_stream(io.BytesIO((DATA / "crx_flex_1MiB_S512.cpx").read_bytes()),
                      out, "cpu")
    assert len(out.getvalue()) == m["input_bytes"]
    assert hashlib.sha256(out.getvalue()).hexdigest() == m["input_sha256"]
