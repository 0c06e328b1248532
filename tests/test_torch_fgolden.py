"""The committed JAX crf archives written under ``CPX_F_FINDER=scan`` (mode
F's decisions from mode X's finder and parse): the 1 and 8 MiB corpus with
mode X's sort finder, the 1 MiB corpus also under ``CPX_X_FINDER=scan``.
On the CPU the port decodes the 1 MiB ones to the committed corpus; on a
card (``cuda``) it writes each of the three again, byte for byte, with the
knobs of its ``argv`` set for the call.  No JAX here: the card machine has
none (run the ``cuda`` tests with ``--noconftest``)."""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from comprox_tpu_torch.cli import main as cli
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import container as con
from comprox_tpu_torch.codec import fast as tfast

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
META = json.loads((DATA / "torch_golden.json").read_text())
ONE_MIB = ("crf_scan_flex_1MiB_S512.cpx", "crf_xscan_flex_1MiB_S512.cpx")
ALL = ONE_MIB + ("crf_scan_flex_8MiB_S512.cpx",)


def decoded(name, device):
    out = io.BytesIO()
    con.decode_stream(io.BytesIO((DATA / name).read_bytes()), out, device)
    return out.getvalue()


def knobs_of(name):
    """``{knob: value}`` and the command line of a golden's ``argv``."""
    argv = META[name]["argv"].split()
    return dict(a.split("=") for a in argv if "=" in a), [a for a in argv if "=" not in a]


@pytest.mark.parametrize("name", ONE_MIB)
def test_port_decodes_the_scan_route_goldens(name):
    m = META[name]
    raw = decoded(name, "cpu")
    assert len(raw) == m["input_bytes"]
    assert hashlib.sha256(raw).hexdigest() == m["input_sha256"]
    knobs, argv = knobs_of(name)
    assert knobs["CPX_F_FINDER"] == "scan"
    assert knobs.get("CPX_X_FINDER", "sort") == ("scan" if "_xscan_" in name else "sort")
    assert argv[:2] == ["crf", "e"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ALL)
def test_card_writes_the_scan_route_goldens(cuda_device, name, monkeypatch):
    m = META[name]
    data = decoded(name, cuda_device)
    knobs, argv = knobs_of(name)
    monkeypatch.setattr(tfast, "_F_FINDER", knobs["CPX_F_FINDER"])
    monkeypatch.setitem(blk._ENV, "CPX_X_FINDER", knobs.get("CPX_X_FINDER", "sort"))
    codec, _, _, _, opts = cli.parse_args(argv + ["in", "out"])
    blk.reset_launch_counts()
    buf = io.BytesIO()
    con.encode_stream(np.frombuffer(data, np.uint8), buf, cli.make_params(codec, opts),
                      cuda_device)
    assert blk.LAUNCHES["K7"] == 0 and blk.LAUNCHES["K6"] == 2
    assert blk.LAUNCHES["KSx" if "_xscan_" in name else "K4x"] == 1
    assert hashlib.sha256(buf.getvalue()).hexdigest() == m["archive_sha256"]
