"""The port's probes (``comprox_tpu_torch/benchmarks/probes.py``) against the
JAX package's Pallas probes (``benchmarks/pallas_probe.py``,
``pallas_probe2.py``), on the CPU.

Each JAX probe runs as written, in Pallas interpret mode: the test patches
``pl.pallas_call`` to ``interpret=True``, sets the module's ``S`` to 64 and
replaces its ``timeit`` by a function that calls the probe's jitted function
once and keeps its inputs and output.  The port's function then gets the
same inputs and must return the JAX output exactly (P8: ``bf16(table)[idx]``,
which the JAX one-hot bf16 product equals; P5 and P9: ``table[idx]``, the
check the JAX probes print, see ``test_jax_dma_kernels_overwrite_a_slot_
before_reading_it``).  The kernels themselves are held against these plain
versions on the card by ``tests/test_torch_kernels.py`` (``cuda`` marker).
"""

import contextlib
import functools
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import pallas_probe, pallas_probe2
from comprox_tpu_torch.benchmarks import probes
from comprox_tpu_torch.utils import build

LANES = 64
MODULE = {k: pallas_probe for k in pallas_probe.PROBES} | {
    k: pallas_probe2 for k in pallas_probe2.PROBES}
# captured calls a probe makes: one per geometry (P2: two, P4: its two arms)
N_CALLS = {"p1": 4, "p1b": 3, "p2": 8, "p3": 1, "p4": 2, "p5": 2, "p6": 5,
           "p7": 4, "p8": 2, "p9": 1}
_RUNS: dict = {}

torch.set_num_threads(1)


def jax_run(key):
    """``(calls, stdout)`` of the JAX probe ``key`` in interpret mode:
    ``calls`` the (numpy inputs, numpy output) of each timed function."""
    if key not in _RUNS:
        mod = MODULE[key]
        calls = []

        def capture(fn, *args, n=20, warmup=3):
            calls.append(([np.asarray(a) for a in args], np.asarray(fn(*args))))
            return 0.0

        out = io.StringIO()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pl, "pallas_call",
                       functools.partial(pl.pallas_call, interpret=True))
            mp.setattr(mod, "S", LANES)
            mp.setattr(mod, "timeit", capture)
            np.random.seed(0)
            with contextlib.redirect_stdout(out):
                mod.PROBES[key]()
        _RUNS[key] = calls, out.getvalue()
    return _RUNS[key]


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("key", sorted(N_CALLS))
def test_jax_probe_runs_in_interpret_mode(key):
    """Every JAX probe lowers and runs; a probe that stops lowering prints
    FAILED and must not pass quietly."""
    calls, out = jax_run(key)
    assert "FAILED" not in out, out
    assert len(calls) == N_CALLS[key], out


PORT = {
    "p1": probes.probe_vmem_gather,
    "p1b": probes.probe_vmem_gather_1d,
    "p3": probes.probe_dynslice_loop,
    "p6": probes.probe_taa,
    "p7": probes.probe_elem,
}


@pytest.mark.parametrize("key", sorted(PORT))
def test_port_gathers_equal_jax(key):
    for (table, idx), want in jax_run(key)[0]:
        got = PORT[key](t(table), t(idx))
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        assert np.array_equal(got.numpy(), want)
        if key == "p1":
            assert np.array_equal(
                probes.probe_vmem_gather(t(table), t(idx), "thread").numpy(), want)


def test_port_onehot_matmul_equals_jax():
    """P2: the f32 product equals JAX's HIGHEST product and the gather; the
    bf16 arm equals JAX's bf16 product."""
    calls = jax_run("p2")[0]
    for ((table, idx), hi), ((_, _), bf) in zip(calls[0::2], calls[1::2]):
        got = probes.probe_onehot_matmul(t(table), t(idx))
        assert np.array_equal(got.numpy(), hi) and np.array_equal(hi, table[idx])
        got_bf = probes.probe_onehot_matmul(t(table), t(idx), bf16=True)
        assert got_bf.dtype == torch.float32
        assert np.array_equal(got_bf.numpy(), bf)


def test_port_persistent_steps_equal_jax():
    """P4: the persistent arm equals JAX's ``run_pallas`` ([S, 1]), the
    launch-per-step arms its ``run_scan`` ([S])."""
    ((table,), pallas_out), ((table2,), scan_out) = jax_run("p4")[0]
    assert np.array_equal(table, table2)
    got = probes.probe_persistent_steps(t(table), LANES, 512)
    assert tuple(got.shape) == (LANES, 1) and np.array_equal(got.numpy(), pallas_out)
    for arm in ("launch", "graph"):
        got = probes.probe_persistent_steps(t(table), LANES, 512, arm)
        assert np.array_equal(got.numpy(), scan_out)
    assert np.array_equal(pallas_out[:, 0], scan_out)


def test_port_kernel_onehot_equals_jax():
    """P8: JAX's bf16 one-hot product is exactly ``bf16(table)[idx]`` (its
    own ``allclose`` check prints exact=False: up to 64 off the f32 table);
    the port returns the same."""
    for (table, idx), want in jax_run("p8")[0]:
        got = probes.probe_kernel_onehot(t(table), t(idx))
        assert np.array_equal(got.numpy(), want)
        ref = t(table).bfloat16()[t(idx).long()].float().numpy()
        assert np.array_equal(want, ref)
        assert 0 < np.abs(want - table[idx]).max() <= 64


@pytest.mark.parametrize("key", ["p5", "p9"])
def test_port_dma_probes_return_table_rows(key):
    """P5, P9: ``table[idx]``, the check the JAX probes print (row r holds
    r in every column)."""
    for (table, idx), _ in jax_run(key)[0]:
        fn = probes.probe_dma if key == "p9" else probes.probe_dma_depth
        got = fn(t(table), t(idx))
        assert np.array_equal(got.numpy(), table[idx])
        assert np.array_equal(got.numpy()[:, 0], idx)


@pytest.mark.parametrize("key,call", [("p5", 0), ("p5", 1), ("p9", 0)])
def test_jax_dma_kernels_overwrite_a_slot_before_reading_it(key, call):
    """The hazard of the JAX P5 and P9 kernels: at step k they start the copy
    of row k + depth into slot (k + depth) % depth, which is slot k % depth,
    before they wait on that slot and read it.  In interpret mode a copy
    lands at once, so step k reads row idx[k + depth] for k < S - depth
    (the last depth steps read their own rows): the output is
    ``table[idx]`` shifted by depth, and the probe prints exact=False.  On
    the TPU the result depended on DMA timing.  The port reads slot k %
    depth before it starts row k + depth into it."""
    (table, idx), out = jax_run(key)[0][call]
    depth = 16 if key == "p9" else (16, 32)[call]
    ref = table[idx]
    assert np.array_equal(out[:LANES - depth], ref[depth:])
    assert np.array_equal(out[LANES - depth:], ref[LANES - depth:])
    assert not np.array_equal(out, ref)
    assert "exact=False" in jax_run(key)[1]


@pytest.mark.parametrize("key", sorted(probes.PROBES))
def test_probe_cases_on_the_cpu(key):
    """Each probe's cases at 64 lanes: the function equals its plain version
    (both plain on the CPU), the bound is positive, and a probe with a
    kernel counts under its own name.  P8's bound is its bf16 operations
    (the bytes of bf16(table)[idx] take less time); the headline cases (the
    probe's row of chip_smoke's kernels line is its last) are P1's flat
    arm, P3's bulk-copy arm, P4's persistent arm and P5's ring at depth 16
    and 32 (not P1's flat gather on its rows), and only they count under
    the probe's name."""
    cases = probes.PROBES[key]("cpu", LANES, seed=1)
    heads = [c for c in cases if c.headline]
    assert len(heads) == {"p1": len(cases) // 2, "p3": 1, "p4": 1, "p5": 2}.get(
        key, len(cases))
    if key == "p3":
        assert len(cases) == 2 and "bulk copies" in heads[0].label
    if key == "p5":
        assert len(cases) == 3 and all("row-DMA depth=" in c.label for c in heads)
    for case in cases:
        assert (case.counter == case.probe) == case.headline, case.label
        assert case.counter in probes.LAUNCHES or key == "p2"
    for case in cases:
        got = case.kernel()
        assert probes.max_abs_err(got, case.plain()) == 0, case.label
        seconds, by = case.bound()
        assert seconds > 0 and by in ("bytes", "operations")
        assert case.probe.lower() == key and case.label.startswith(case.probe + " ")
        assert (case.probe in probes.LAUNCHES) == (key != "p2")
        if case.reference is not None:
            assert 0 < probes.max_abs_err(got, case.reference()) <= 64
        if key == "p8":
            assert by == "operations"


def test_docstring_names_every_pallas_call():
    """The module docstring's table names each JAX probe at the line of its
    ``def`` and of its ``pl.pallas_call`` (P2 has none: plain XLA)."""
    n_calls = 0
    for mod in (pallas_probe, pallas_probe2):
        src = Path(mod.__file__).read_text().splitlines()
        defs = [(i + 1, m.group(1)) for i, line in enumerate(src)
                if (m := re.match(r"def (probe_\w+)\(", line))]
        for k, (line, name) in enumerate(defs):
            end = defs[k + 1][0] if k + 1 < len(defs) else len(src) + 1
            calls = [i + 1 for i in range(line, end - 1) if "pl.pallas_call(" in src[i]]
            n_calls += len(calls)
            row = re.search(rf":func:`{name}`\s+``[\w/.]*?:{line}`` \((.*?)\)$",
                            probes.__doc__, re.M)
            assert row, name
            want = f":{calls[0]}" if calls else "plain XLA: no kernel"
            assert row.group(1).startswith(want), (name, row.group(1))
    assert n_calls == 9


def test_probe_kernels_are_built_and_counted():
    """The probes' C entry points are in the build table; every probe
    function with a kernel has its launch counter."""
    src = (build.CSRC / "probes.cu").read_text()
    entries = set(re.findall(r'extern "C" int (cpx_pr_\w+)\(', src))
    assert entries and entries <= set(build._SIGNATURES)
    assert set(probes.LAUNCHES) == {"P1", "P1t", "P1b", "P3", "P3w", "P4", "P4s",
                                    "P5", "P5w", "P6", "P7", "P8", "P9"}
    for name in ("pallas_probe.py::probe_vmem_gather", "probe_vmem_gather_1d",
                 "probe_dynslice_loop", "probe_persistent_steps", "probe_dma_depth",
                 "pallas_probe2.py::probe_taa", "probe_elem", "probe_kernel_onehot",
                 "probe_dma"):
        assert name in src, name
    probes.reset_launch_counts()
    assert not any(probes.LAUNCHES.values())


def test_probes_measure_only_on_a_card():
    """Timing and the command line need a CUDA card: no number comes from
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        probes.timeit(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        probes.run(["p1"])
    with pytest.raises(SystemExit, match="unknown probe"):
        probes.main(["p10"])
