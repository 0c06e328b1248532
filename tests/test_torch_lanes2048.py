"""Blocks of more lanes than a CTA has threads (``-l2048``): the committed
JAX archives of each codec at S=2048, T=8 (two blocks of a 32 KiB corpus
of words) through the port on the CPU.  Each decodes to its corpus and
the port writes it again byte for byte.  On a card the step scans run
such a block as a cluster of two CTAs and crf's K9/K10 at two lanes a
thread (chip_smoke.py checks the same archives there)."""

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

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
META = json.loads((DATA / "torch_golden.json").read_text())
WIDE = sorted(n for n in META if n.endswith("_S2048.cpx"))


def test_one_wide_golden_per_codec():
    assert [n[:3] for n in WIDE] == ["crf", "crp", "crx", "crz"]
    for name in WIDE:
        assert META[name]["argv"].endswith(" e -b0.015625 -l2048")
        assert META[name]["input_bytes"] == 2 * 2048 * 8


@pytest.mark.parametrize("name", WIDE)
def test_wide_golden_decodes_and_is_written_again(name):
    m = META[name]
    arc = (DATA / name).read_bytes()
    assert hashlib.sha256(arc).hexdigest() == m["archive_sha256"]
    blk.reset_launch_counts()
    out = io.BytesIO()
    con.decode_stream(io.BytesIO(arc), out, "cpu")
    assert hashlib.sha256(out.getvalue()).hexdigest() == m["input_sha256"]
    codec, _, _, _, opts = cli.parse_args(m["argv"].split() + ["in", "out"])
    cp = cli.make_params(codec, opts)
    assert (cp.block.lanes, cp.block.steps) == (2048, 8)
    buf = io.BytesIO()
    con.encode_stream(np.frombuffer(out.getvalue(), np.uint8), buf, cp, "cpu")
    assert buf.getvalue() == arc
    assert not any(blk.LAUNCHES.values())  # CPU tensors: the plain versions


@pytest.mark.parametrize("codec", ["crz", "crx", "crp", "crf"])
def test_wide_block_lane_limits_of_the_kernels(codec):
    """The checks the wrappers make before a launch: the step scans take up
    to 8192 lanes (a cluster of eight CTAs), and so do K9 and K10 (eight
    lanes a thread)."""
    def params(lanes):
        return cli.make_params(codec, {"lanes": lanes, "block_mb": 1}).block

    for lanes in (1024, 2048, 8192):
        blk._check_kernel_geometry(params(lanes))
    with pytest.raises(NotImplementedError, match="lanes <= 8192"):
        blk._check_kernel_geometry(params(16384))
