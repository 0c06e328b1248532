"""The x86-64 ``-F`` check: JAX archives of the ELF corpus (the ELF files of
``/usr/bin``, then ``/usr/lib/x86_64-linux-gnu``, in name order, cut to
8 MiB; ``tests/data/make_torch_golden.py --corpus elf``) under ``crx e -F``
and ``crz e -F``.  The 256 KiB ones (S=512, T=512) decode on the CPU and
the port writes them again byte for byte; the 8 MiB ones, at the geometry
where README.md's ratios were measured (S=256), are decoded and written
again on a card by chip_smoke.py."""

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
ELF = sorted(n for n in META if "_elfF_" in n)
BASELINE_MD5 = "4ccf1412"  # BASELINE.md's binary-corpus table
# the geometry of README.md's ratios on this corpus (crx 2.5207, crz 2.5484)
WHERE_MEASURED = {"crx": "-b16 -l256", "crz": "-b8 -l256"}


def test_elf_goldens_and_their_corpus():
    """Both codecs at 256 KiB and 8 MiB, all from the corpus of BASELINE.md's
    binary table (same md5 prefix), the 256 KiB ones its first bytes."""
    assert ELF == [f"{c}_elfF_flex_{s}.cpx" for c in ("crx", "crz")
                   for s in ("256KiB_S512", "8MiB_S256")]
    for name in ELF:
        m = META[name]
        assert m["corpus_md5"].startswith(BASELINE_MD5)
        assert " -F " in m["argv"]
        assert m["argv"].endswith(WHERE_MEASURED[name[:3]] if "8MiB" in name
                                  else "-b0.25 -l512")
    small = {META[n]["input_sha256"] for n in ELF if "256KiB" in n}
    big = {META[n]["input_sha256"] for n in ELF if "8MiB" in n}
    assert len(small) == len(big) == 1


@pytest.mark.parametrize("name", [n for n in ELF if "256KiB" in n])
def test_elf_golden_256kib_decodes_and_is_written_again(name):
    m = META[name]
    arc = (DATA / name).read_bytes()
    assert hashlib.sha256(arc).hexdigest() == m["archive_sha256"]
    out = io.BytesIO()
    con.decode_stream(io.BytesIO(arc), out, "cpu")
    data = np.frombuffer(out.getvalue(), np.uint8)
    assert hashlib.sha256(data.tobytes()).hexdigest() == m["input_sha256"]
    assert data[:4].tobytes() == b"\x7fELF"
    codec, _, _, _, opts = cli.parse_args(m["argv"].split() + ["in", "out"])
    assert opts["filters"] and opts["lanes"] == 512
    buf = io.BytesIO()
    con.encode_stream(data, buf, cli.make_params(codec, opts), "cpu",
                      filters=True)
    assert buf.getvalue() == arc
