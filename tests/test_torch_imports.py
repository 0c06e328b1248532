"""The port stands alone: importing it, or the chip smoke script, loads
nothing of the JAX package and no JAX, in a fresh interpreter."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CHECK = (
    "import sys; "
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('comprox_tpu', 'jax', 'jaxlib')); "
    "assert not bad, bad; print('alone')"
)

PORT_MODULES = [
    "comprox_tpu_torch",
    "comprox_tpu_torch.benchmarks.phases",
    "comprox_tpu_torch.benchmarks.probes",
    "comprox_tpu_torch.benchmarks.ring_depth",
    "comprox_tpu_torch.benchmarks.sort_keys",
    "comprox_tpu_torch.cli.main",
    "comprox_tpu_torch.codec.block",
    "comprox_tpu_torch.codec.container",
    "comprox_tpu_torch.codec.dictionary",
    "comprox_tpu_torch.codec.fast",
    "comprox_tpu_torch.models.ppm",
    "comprox_tpu_torch.models.tables",
    "comprox_tpu_torch.ops.filters",
    "comprox_tpu_torch.ops.rans",
    "comprox_tpu_torch.ops.rans_scalar",
    "comprox_tpu_torch.utils.build",
    "comprox_tpu_torch.utils.native",
]


def run_fresh(code):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_every_port_module_imports_alone():
    r = run_fresh("import " + ", ".join(PORT_MODULES) + "; " + CHECK)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "alone"


def test_port_modules_are_all_listed():
    found = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "comprox_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    }
    assert found <= set(PORT_MODULES), found - set(PORT_MODULES)


def test_codec_loads_no_probe_module():
    """The codec and its command line import nothing of ``benchmarks/``,
    the port's or the JAX package's."""
    r = run_fresh(
        "import comprox_tpu_torch.cli.main, comprox_tpu_torch.codec.container; "
        "import sys; bad = sorted(m for m in sys.modules if m == 'benchmarks' "
        "or m.startswith(('benchmarks.', 'comprox_tpu_torch.benchmarks'))); "
        "assert not bad, bad; print('alone')")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "alone"


def test_chip_smoke_imports_alone():
    r = run_fresh("import chip_smoke; " + CHECK)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "alone"


def test_port_sources_name_no_jax_import():
    """No source line of the port or the smoke script imports JAX or the
    JAX package."""
    files = list((ROOT / "comprox_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "comprox_tpu"), (path, line)


def test_encode_and_decode_load_no_jax(tmp_path):
    """The flexible encode and the decode, run in a fresh interpreter, pull
    in nothing of the JAX package on the way (dictionary stage included)."""
    src = tmp_path / "in.bin"
    src.write_bytes(b"the quick brown fox jumps over the lazy dog. " * 120)
    code = (
        "import comprox_tpu_torch.cli.main as m; "
        f"m.run('crz', ['e', {str(src)!r}, {str(tmp_path / 'a.crz')!r}, "
        "'-b0.0005', '-l8', '-q'], device='cpu'); "
        f"m.run('crz', ['d', {str(tmp_path / 'a.crz')!r}, "
        f"{str(tmp_path / 'out.bin')!r}, '-q'], device='cpu'); " + CHECK
    )
    r = run_fresh(code)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "out.bin").read_bytes() == src.read_bytes()


def test_crf_encode_and_decode_load_no_jax(tmp_path):
    """The same for the fast profile: crf e / crf d in a fresh interpreter."""
    src = tmp_path / "in.bin"
    src.write_bytes(b"the quick brown fox jumps over the lazy dog. " * 120)
    code = (
        "import comprox_tpu_torch.cli.main as m; "
        f"m.run('crf', ['e', {str(src)!r}, {str(tmp_path / 'a.crf')!r}, "
        "'-b0.002', '-l8', '-q'], device='cpu'); "
        f"m.run('crf', ['d', {str(tmp_path / 'a.crf')!r}, "
        f"{str(tmp_path / 'out.bin')!r}, '-q'], device='cpu'); " + CHECK
    )
    r = run_fresh(code)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "out.bin").read_bytes() == src.read_bytes()


@pytest.mark.parametrize("codec,env", [("crp", {}), ("crx", {"CPX_X_FINDER": "scan"}),
                                       ("crz", {"CPX_R_FINDER": "scan"})])
def test_new_paths_encode_and_decode_load_no_jax(tmp_path, codec, env):
    """crp e / crp d, and the scan finders of crx and crz (read from the
    environment at import), in a fresh interpreter."""
    src = tmp_path / "in.bin"
    src.write_bytes(b"the quick brown fox jumps over the lazy dog. " * 120)
    code = (
        "import comprox_tpu_torch.cli.main as m; "
        "from comprox_tpu_torch.codec import block; "
        f"assert block._ENV['CPX_X_FINDER'] == {env.get('CPX_X_FINDER', 'sort')!r}; "
        f"m.run({codec!r}, ['e', {str(src)!r}, {str(tmp_path / 'a.cpx')!r}, "
        "'-b0.0005', '-l8', '-q'], device='cpu'); "
        f"m.run({codec!r}, ['d', {str(tmp_path / 'a.cpx')!r}, "
        f"{str(tmp_path / 'out.bin')!r}, '-q'], device='cpu'); " + CHECK
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1", **env))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "alone"
    assert (tmp_path / "out.bin").read_bytes() == src.read_bytes()
