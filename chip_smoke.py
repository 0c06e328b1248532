#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (comprox_tpu_torch) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit and
no result line:

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build: compiles the kernels (``comprox_tpu_torch/csrc``: fifteen
   sources, twenty-four codec kernels counting the entries of modes X and
   P and the chain arms of K5 and K1, the shared radix sort and the six
   probe kernels) with nvcc, one process
   per source, and beside them the instrumented builds of
   ``benchmarks/phases.py`` (two of ``decode.cu``, K1's, K12d's and K13d's
   phase stamps at row-ring depth 0 and at the build's depth; one of
   ``rank.cu`` and ``model.cu``, K5's and the modeling scan's, K2, K12e and
   K13e), all started together; prints the registers and spills of every
   arm of the step scans and per-lane passes (K1, K12d/K13d, the modeling
   scan K2/K12e/K13e: four lanes a round of the A event at up to 512
   threads, two above; K5, K6, K11, K3, K3p), of K13c, K3b's pass and
   K9's token pass, and of
   K4's find and final stage (each candidate count; the final stage with
   and without the diagonal-run scan).
3. golden: decodes the committed JAX-package archives
   (``tests/data/torch_golden.json``: one 1 MiB and one 8 MiB corpus, each
   under ``crz e -l512`` with the flexible parse and with ``-f0``, under
   ``crf e -l512``, under ``crx e -l512`` (the 1 MiB one also with ``-f0``;
   both sizes also under ``CPX_X_FINDER=scan``), under ``crp e -l512`` and
   under ``CPX_F_FINDER=scan crf e -l512`` (the 1 MiB one also under
   ``CPX_X_FINDER=scan``; phase 26 codes those two);
   the x86-64 ELF corpus at 256 KiB and 8 MiB under ``crx e -F`` and ``crz
   e -F``; a 32 KiB corpus of words under each codec at ``-l2048`` with
   T=8, two blocks; the 8 MiB corpus chained at ``-b2``, four blocks of
   T=4096, under ``crz -c``, ``crz -C``, ``crx -c`` and ``crp -c``; the 16
   MiB corpus of phase 17 under ``crz -C -b8``; the ``-g4`` goldens are
   phase 21's) on the card and checks the
   decoded bytes' SHA-256;
   re-encodes each corpus that no full-width phase below codes, under its
   archive's command line, and checks that each archive's SHA-256 equals
   the JAX package's; each decode and encode must launch kernels.  The
   S=2048 archives run the step scans as clusters of two CTAs and crf's
   K10 at two lanes a thread.
   The decoded corpora are the inputs of the next phases, so every machine
   runs the same bytes.
4. kernels, mode R: each of KS, K4, K5, K6, K2, K3, K3b (the stream
   compaction, on K3p's mask of K3's emissions) and K1 against its plain
   PyTorch version on the card, at S=512 lanes, full-size tables, T=256
   steps, on corpus bytes (K4 also at the main path's N = 8 Mi positions,
   where its sort stage is timed beside ``torch.sort`` on the same keys
   and each of its stages is timed, keys, sort, find and final stage; K4
   at both sizes also with ``CPX_SORT_EXT`` set to 8 for the call, the
   final stage's diagonal-run scan, its error folded into K4's; K3b
   beside ``words[emit]``, one ``masked_select``);
   every output and table must be equal (tolerance 0: the codec is integer
   arithmetic).  Computes each kernel's bound from these inputs.
5. kernels, chain mode v2: KCR (the bucket-table remap), K5's chain arm,
   K3p (the emission mask's bit-pack) and K1's chain arm against their
   plain versions at S=512, T=256, full tables, from the state one block
   of the 8 MiB corpus' first S*T bytes leaves, on its next S*T bytes;
   tolerance 0 on every grid and table; the unchained K5's and K1's ms on
   that block beside, and KCR's ms also with the stream idle before each
   launch, after 100 ms of an idle card and into a fresh allocation.
6. sort: the radix sort shared by K4, K4x and K7 (``csrc/sortlib.cuh``)
   against ``torch.sort(stable=True)`` on the adversarial key sets of
   ``benchmarks/sort_keys.py`` (keys and positions, tolerance 0; the
   passes it ran against the digits that vary), then on K4's keys of the
   8 MiB corpus (the main path's N = 8 Mi), timed beside ``torch.sort`` on
   int64 and int32 keys.
7. kernels, mode F: K7 and K8 against their plain versions at the full
   N = 8 Mi (S=512, T=16384) on the 8 MiB corpus (K8 also on an all-zero
   block, the corpus 1003 bytes short and three kinds of synthetic
   decisions: take 2, takes of 250, random takes capped at each lane's
   end), K9 on the first S * 256 tokens of that block, K10 on the stream
   of all its tokens (padded, and cut to its words so that the window
   clamps), K6's mode-F entry at T=256; tolerance 0.  K7's, K8's, K9's
   (all its tokens) and K10's stages (``benchmarks/phases.py``) beside.
   Beside K7's sort stage, K8's scans and K9's histogram it times the one
   PyTorch call for the same function (``torch.sort``, ``torch.cumsum``,
   ``torch.bincount``), which the port never uses.
8. kernels, mode X: K4x at N = 8 Mi (its sort stage beside ``torch.sort``,
   its stages timed) and at T=256, at both also with ``CPX_SORT_EXT=8``
   as K4; K6's X entry (both launches: without and with the repeat
   pair), K11, K12e, K3, K3p and K3b at five slots and K12d chained at
   S=512, full tables, T=256, each against its plain version (K3b beside
   ``words[emit]``); tolerance 0 on every
   output grid and every table.  KSx (the scan finder's search) the same
   way: six grids, both bucket tables and the near-match cache.
9. kernels, K6 and K11 cases: K6 in each arm (R, F, X without and with the
   repeat pair) and K11 against their plain versions on the adversarial
   inputs of ``tests/test_torch_parse_order.py``: dense random candidates,
   every candidate tied, a literal price that saturates the cost-to-go,
   ``min_len`` 1, and K11 on random decisions over bytes of long equal
   runs; at S=512, T=256 and at a ragged S=104, T=77; tolerance 0.
10. kernels, mode P: K13c (the whole block's LZP candidates: the grid and
   the ``lzp2/4/8`` it leaves), then K13e on K13c's grid, K3 and K13d
   chained at S=512, T=256, full-size LZP tables, each against its plain
   version; tolerance 0 on every grid, every PPM table, ``sse_p`` and
   ``lzp2/4/8``.
11. kernels, blocks: every batched arm of the block axis (one launch codes
   G blocks: K5, K6, K2 in mode R, K11, K6 twice, K12e in mode X, K13e,
   K3, K3p and K3b at three and five slots, K1, K12d, K13d) against G one-block
   launches of the same kernel and against the plain loop (the plain
   version on each block in turn), G = 4 blocks of S=512, T=256, full
   tables, four consecutive spans of the corpus, the last 1003 bytes
   short; tolerance 0 on every grid, table, state and stream; the batched
   launch's ms beside the G one-block launches'.  The ``(blocks)`` rows of
   the kernels line.
12. probes: the nine Pallas probes of the JAX package's ``benchmarks/`` as
   the port runs them (``comprox_tpu_torch/benchmarks/probes.py``, kernels
   in ``csrc/probes.cu``): each at each of its own geometries (S=512)
   against its plain version, tolerance 0 (P8 against ``bf16(table)[idx]``;
   its error against the f32 gather is printed), timed beside the plain
   version, one PyTorch call for the same function and the bound; one line
   a geometry, as ``python -m comprox_tpu_torch.benchmarks.probes`` prints
   them.  The kernels line carries each probe's last headline case (P1: its
   flat gather; P3: its bulk-copy arm; P4: its persistent arm; P5: its ring
   at depth 32) and the launches of the whole phase under the probe's
   name, which count the headline arms only: the other arms count apart
   (P1's thread a row under ``P1t``, P3's one warp under ``P3w``, P4's
   launch a step under ``P4s``, P1's flat gather on P5's rows under
   ``P5w``).  Every key must launch.  The phase's first line is the launch
   floor (an empty kernel, no key).
13. full width, the crp path: ``crp e -b8 -l512`` then ``crp d`` through the
   CLI; archive SHA-256 == the JAX golden; fails if K13c, K13e, K3, K3p,
   K3b or K13d was not launched.
14. full width, the crx path under the scan finder: ``crx e -b8 -l512`` with
   ``CPX_X_FINDER=scan``; archive SHA-256 == the JAX golden written under
   that knob; fails if KSx, K6, K11, K12e, K3, K3p, K3b or K12d was not
   launched, or if K4x was.
15. full width, the crx path: ``crx e -b8 -l512`` then ``crx d`` through the
   CLI on the 8 MiB corpus; archive SHA-256 == the JAX golden, round trip
   bit-exact; fails if K4x, K11, K6, K12e, K3, K3p, K3b, K12d or the sort was
   not launched.
16. full width, the flexible crz path: ``crz e -b8 -l512`` then ``crz d``
   through ``comprox_tpu_torch.cli.main`` on the 8 MiB corpus, one block of
   S=512 and T=16384.  The archive's SHA-256 must equal the JAX package's
   and the round trip must be bit-exact; prints MB/s, bpb and the kernel
   times, and fails if K4, K5, K6, K2, K3, K3p, K3b, K1 or the sort was not
   launched.
17. full width, chain mode v2: ``crz e -C -b8 -l512`` then ``crz d`` on
   16 MiB, the 8 MiB text corpus followed by the 8 MiB ELF corpus (both
   decoded from committed goldens), two chained blocks of S=512 and
   T=16384; archive SHA-256 == the JAX golden, round trip bit-exact; MB/s,
   each kernel's ms per launch, the bpb beside the unchained ``-b8``
   archive of the same input; fails unless K4, KCR (twice a side), K5ch,
   K6, K2, K3, K3p, K3b, K1ch and the sort were launched, or if K5 or K1
   was.
18. the step scans by phase: the same archive decoded through K1's two
   instrumented builds of phase 2, at ring depth 0 (the o2 or o1 rows of a
   pair of lanes issued when they are read, nothing in flight ahead) and
   at the build's depth, and its corpus encoded again through K5's and
   K2's (the archive's SHA-256 == the JAX golden), and the 8 MiB crx and
   crp archives decoded through K12d's and K13d's at the same two depths
   and their corpora encoded again through K12e's and K13e's;
   each phase's share of the kernel's cycles and its microseconds a step
   (K5, K2, K12e, K13e, K12d, K13d: on thread 0 and on the CTA's last
   thread).
19. full width, the greedy crz path: the same with ``-f0``; fails if KS, K2,
   K3, K3p, K3b or K1 was not launched.
20. full width, the crf path: ``crf e -b8 -l512`` then ``crf d`` the same
   way; fails if K7, K6, K8, K9, K10 or the sort was not launched.  Then the host's
   share of that path, stage by stage (dictionary, block encode and decode,
   the LZ copy walk, the CRC).  (It runs after phases 21 to 23 and is
   printed as phase 24.)
21. golden, -b2: the JAX package's ``-g4 -b2`` goldens (four blocks of
   T=4096 of the 8 MiB corpus; crz, crx, crp, crf), which phase 3 leaves
   out, decoded with ``-g4`` and with ``-g1`` to the corpus, and the corpus
   encoded again with ``-g4`` and with ``-g1`` to JAX's SHA-256; ``-g1``
   runs the pipelined schedule, and the calls to the block codec's
   ``start`` are counted (one a block).
22. full width, -g4: ``crz|crx|crp e -b8 -l512 -g4`` against ``-g1`` on 29
   MiB + 777 bytes, four distinct full-width blocks (the 8 MiB text and
   ELF corpora of phase 17, each rotated by 4 MiB, the last cut to 5 MiB +
   777 bytes); the archives byte-equal and ``d -g4`` bit-exact; walls,
   MB/s, kernel ms of each launch, device time and idle share, peak card
   memory of each, and K5's clusters the card holds at once; fails unless
   every kernel of the path (K3b included) was launched.  The launches of
   the ``(blocks)`` rows are this phase's ``-g4`` runs'.
23. pipelined container: ``crz|crx|crp|crf e -b8 -l512`` at ``-g1`` on the
   input of phase 22, through the pipelined schedule (one block in
   flight; each ``start`` under ``torch.cuda.set_sync_debug_mode("error")``,
   mode F's one read of K8's token count allowed) and through the
   sequential one (``encode_fn`` and ``decode_fn`` the one-block codec);
   the archives byte-equal and equal to the ``-g4`` archive, both decodes
   bit-exact; wall, kernel ms, idle share, peak card memory and the device
   gap at each block boundary (``block._launch``'s events: block i's last
   kernel's end to block i+1's first kernel's start) of each; fails unless
   every crz gap of the pipelined schedule is below the sequential gap at
   the same boundary.  Then crz ``-c -b2`` and ``-C -b2`` on the 8 MiB
   corpus under ``CPX_CHAIN_SPEC=1`` (the speculative schedule) and ``0``,
   both to the JAX goldens' SHA-256, and ``encode_block_stats`` on one
   full-width crz block (``stream_words`` == its payload's word count).
25. payload pack: one 8 MiB block of the crz and of the crx corpus
   encoded (S=512, T=16384; three and five slots), then its payload packed
   from the same K3 outputs two ways, host ms each: the host compaction
   the port ran before K3b (K3p's mask and K3's words copied to the host,
   ``np.unpackbits`` and a boolean index), the yardstick, and
   ``_pack_payload`` (K3b, then the copy of the word count, the states and
   the stream); the two payloads must be equal.
26. full width, crf under mode X's finder: ``CPX_F_FINDER=scan crf e -b8
   -l512`` and ``crf d`` on the 8 MiB corpus, archive SHA-256 == the JAX
   golden written under that knob; fails unless K4x, the sort, K6 (twice:
   mode X's prices, then the repeat pair), K11, K8, K9 and K10 were
   launched, or if K7 was.  The same at 1 MiB (``-b1``) under
   ``CPX_X_FINDER=scan`` as well (KSx, not K4x).  Then one 16 MiB block
   (T=32768) of phase 17's corpus under ``-b16``, round trip bit-exact.
   The walls and kernel ms beside the sort route's of phase 20.
27. -j: ``crz|crx|crp|crf e -b8 -l512 -j`` and ``d -j`` on the input of
   phase 22 over the mesh of every CUDA device (one card here: a mesh of
   one; mode F around the mesh); each archive equal to ``-g1``'s, each
   decode bit-exact; walls, kernel ms, idle share and peak of the card.
28. distributed, two ranks on one card: two processes of ``python -m
   comprox_tpu_torch.parallel.dryrun`` (world 2, gloo, both on
   ``cuda:0``), mode R at S=512 and 8 MiB blocks on phase 22's input (two
   blocks a rank); both return the payloads of one process's
   ``encode_blocks_list`` (SHA-256) and decode the whole input bit-exact;
   each rank's walls and peak; either rank's failure or timeout fails it.
29. dryrun: ``dryrun_multichip(torch.cuda.device_count())`` at the JAX
   package's geometry (S=512, 1 MiB blocks, 2^18 x 64 buckets, 2^22 o3
   entries, the tail 1313 bytes short): round trip bit-exact, payloads
   equal to one device's a block at a time.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data"
WORK = ROOT / "build" / "smoke"
MAIN_ARCHIVE = "crz_flex_8MiB_S512.cpx"  # crz e -b8 -l512
GREEDY_ARCHIVE = "crz_f0_8MiB_S512.cpx"  # crz e -f0 -b8 -l512
FAST_ARCHIVE = "crf_flex_8MiB_S512.cpx"  # crf e -b8 -l512
X_ARCHIVE = "crx_flex_8MiB_S512.cpx"  # crx e -b8 -l512
XSCAN_ARCHIVE = "crx_scan_flex_8MiB_S512.cpx"  # CPX_X_FINDER=scan crx e -b8 -l512
P_ARCHIVE = "crp_8MiB_S512.cpx"  # crp e -b8 -l512
# crf under mode X's finder and parse: CPX_F_FINDER=scan crf e -b8 -l512, and
# at 1 MiB also under CPX_X_FINDER=scan
FSCAN_ARCHIVE = "crf_scan_flex_8MiB_S512.cpx"
FXSCAN_ARCHIVE = "crf_xscan_flex_1MiB_S512.cpx"
# crz e -C -b8 -l512 on the 8 MiB text corpus followed by the 8 MiB ELF
# corpus: two chained blocks
CHAIN_ARCHIVE = "crz_chainm_textelf_flex_16MiB_S512.cpx"
FULL_WIDTH_ARCHIVES = (MAIN_ARCHIVE, GREEDY_ARCHIVE, FAST_ARCHIVE, X_ARCHIVE,
                       XSCAN_ARCHIVE, P_ARCHIVE, CHAIN_ARCHIVE, FSCAN_ARCHIVE,
                       FXSCAN_ARCHIVE)  # re-encoded by the full-width phases
KERNEL_STEPS = 256

PROBES_CU = "comprox_tpu_torch/csrc/probes.cu"
AXIS = ("comprox_tpu/parallel/mesh.py:62", "comprox_tpu/parallel/mesh.py:73")
KERNELS = [
    # name, source, the JAX scan it replaces (file:line)
    ("KS", "comprox_tpu_torch/csrc/search.cu",
     "comprox_tpu/codec/block.py:1333"),
    ("K4", "comprox_tpu_torch/csrc/sortfind.cu",
     "comprox_tpu/codec/block.py:809"),
    ("K5", "comprox_tpu_torch/csrc/rank.cu",
     "comprox_tpu/codec/block.py:1188"),
    ("K6", "comprox_tpu_torch/csrc/parse.cu",
     "comprox_tpu/codec/block.py:1414"),
    ("K2", "comprox_tpu_torch/csrc/model.cu",
     "comprox_tpu/codec/block.py:1677"),
    ("K3", "comprox_tpu_torch/csrc/rans.cu",
     "comprox_tpu/codec/block.py:1945"),
    ("K1", "comprox_tpu_torch/csrc/decode.cu",
     "comprox_tpu/codec/block.py:1980"),
    ("K7", "comprox_tpu_torch/csrc/sortfind.cu",
     "comprox_tpu/codec/fast.py:178"),
    ("K8", "comprox_tpu_torch/csrc/f2tok.cu",
     "comprox_tpu/codec/fast.py:287"),
    ("K9", "comprox_tpu_torch/csrc/f2enc.cu",
     "comprox_tpu/codec/fast.py:446"),
    ("K10", "comprox_tpu_torch/csrc/f2dec.cu",
     "comprox_tpu/codec/fast.py:538"),
    # mode X (crx): entries of the sources above, and K11's own
    ("K4x", "comprox_tpu_torch/csrc/sortfind.cu",
     "comprox_tpu/codec/block.py:809"),
    ("K11", "comprox_tpu_torch/csrc/xrep.cu",
     "comprox_tpu/codec/block.py:1507"),
    ("K6 (X)", "comprox_tpu_torch/csrc/parse.cu",
     "comprox_tpu/codec/block.py:1414"),
    ("K12e", "comprox_tpu_torch/csrc/model.cu",
     "comprox_tpu/codec/block.py:1677"),
    ("K3 (5 slots)", "comprox_tpu_torch/csrc/rans.cu",
     "comprox_tpu/codec/block.py:1945"),
    ("K12d", "comprox_tpu_torch/csrc/decode.cu",
     "comprox_tpu/codec/block.py:1980"),
    # mode X's scan finder, and mode P (crp)
    ("KSx", "comprox_tpu_torch/csrc/search.cu",
     "comprox_tpu/codec/block.py:1333"),
    ("K13c", "comprox_tpu_torch/csrc/lzpcand.cu",
     "comprox_tpu/codec/block.py:362"),
    ("K13e", "comprox_tpu_torch/csrc/model.cu",
     "comprox_tpu/codec/block.py:1677"),
    ("K13d", "comprox_tpu_torch/csrc/decode.cu",
     "comprox_tpu/codec/block.py:1980"),
    # the stable radix sort of K4, K4x and K7 (their lax.sort)
    ("SORT", "comprox_tpu_torch/csrc/sortlib.cuh",
     "comprox_tpu/codec/block.py:854"),
    # the emission mask's bit-pack (every adaptive encode), and chain mode
    # v2 (crz -C): the bucket-table remap and the chain arms of K5 and K1
    ("K3p", "comprox_tpu_torch/csrc/rans.cu",
     "comprox_tpu/codec/block.py:1965"),
    ("K3p (5 slots)", "comprox_tpu_torch/csrc/rans.cu",
     "comprox_tpu/codec/block.py:1965"),
    # the payload's stream compaction (every adaptive encode), on the card
    ("K3b", "comprox_tpu_torch/csrc/rans.cu",
     "comprox_tpu/codec/block.py:2256"),
    ("K3b (5 slots)", "comprox_tpu_torch/csrc/rans.cu",
     "comprox_tpu/codec/block.py:2256"),
    ("KCR", "comprox_tpu_torch/csrc/chain.cu",
     "comprox_tpu/codec/block.py:1255"),
    ("K5ch", "comprox_tpu_torch/csrc/rank.cu",
     "comprox_tpu/codec/block.py:1233"),
    ("K1ch", "comprox_tpu_torch/csrc/decode.cu",
     "comprox_tpu/codec/block.py:2207"),
    # the block axis (-g): one launch over G blocks, the vmap of
    # _encode_passes (mesh.py:62) or _decode_scan (mesh.py:73) beside the
    # kernel's own JAX line
    *((f"{k} (blocks)", src, f"{AXIS[0] if side == 'e' else AXIS[1]}; {repl}")
      for k, src, repl, side in (
          ("K5", "comprox_tpu_torch/csrc/rank.cu", "comprox_tpu/codec/block.py:1188", "e"),
          ("K6", "comprox_tpu_torch/csrc/parse.cu", "comprox_tpu/codec/block.py:1414", "e"),
          ("K2", "comprox_tpu_torch/csrc/model.cu", "comprox_tpu/codec/block.py:1677", "e"),
          ("K3", "comprox_tpu_torch/csrc/rans.cu", "comprox_tpu/codec/block.py:1945", "e"),
          ("K3p", "comprox_tpu_torch/csrc/rans.cu", "comprox_tpu/codec/block.py:1965", "e"),
          ("K1", "comprox_tpu_torch/csrc/decode.cu", "comprox_tpu/codec/block.py:1980", "d"),
          ("K11", "comprox_tpu_torch/csrc/xrep.cu", "comprox_tpu/codec/block.py:1507", "e"),
          ("K6 (X)", "comprox_tpu_torch/csrc/parse.cu", "comprox_tpu/codec/block.py:1414", "e"),
          ("K12e", "comprox_tpu_torch/csrc/model.cu", "comprox_tpu/codec/block.py:1677", "e"),
          ("K3 (5 slots)", "comprox_tpu_torch/csrc/rans.cu", "comprox_tpu/codec/block.py:1945",
           "e"),
          ("K3p (5 slots)", "comprox_tpu_torch/csrc/rans.cu",
           "comprox_tpu/codec/block.py:1965", "e"),
          ("K3b", "comprox_tpu_torch/csrc/rans.cu", "comprox_tpu/codec/block.py:2256", "e"),
          ("K3b (5 slots)", "comprox_tpu_torch/csrc/rans.cu",
           "comprox_tpu/codec/block.py:2256", "e"),
          ("K12d", "comprox_tpu_torch/csrc/decode.cu", "comprox_tpu/codec/block.py:1980", "d"),
          ("K13e", "comprox_tpu_torch/csrc/model.cu", "comprox_tpu/codec/block.py:1677", "e"),
          ("K13d", "comprox_tpu_torch/csrc/decode.cu", "comprox_tpu/codec/block.py:1980", "d"),
      )),
    # the Pallas probes of benchmarks/ (their pl.pallas_call lines)
    ("P1", PROBES_CU, "benchmarks/pallas_probe.py:56"),
    ("P1b", PROBES_CU, "benchmarks/pallas_probe.py:97"),
    ("P3", PROBES_CU, "benchmarks/pallas_probe.py:164"),
    ("P4", PROBES_CU, "benchmarks/pallas_probe.py:204"),
    ("P5", PROBES_CU, "benchmarks/pallas_probe.py:272"),
    ("P6", PROBES_CU, "benchmarks/pallas_probe2.py:51"),
    ("P7", PROBES_CU, "benchmarks/pallas_probe2.py:100"),
    ("P8", PROBES_CU, "benchmarks/pallas_probe2.py:142"),
    ("P9", PROBES_CU, "benchmarks/pallas_probe2.py:203"),
]


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def max_err(pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


@contextlib.contextmanager
def finder_knob(knob, value):
    """The port's finder knob (read from the environment at import) set to
    ``value`` for the block."""
    from comprox_tpu_torch.codec import block as blk

    old, blk._ENV[knob] = blk._ENV[knob], value
    try:
        yield
    finally:
        blk._ENV[knob] = old


@contextlib.contextmanager
def f_finder_knob(value):
    """The port's mode-F finder (CPX_F_FINDER, read at import) set to
    ``value`` for the block."""
    from comprox_tpu_torch.codec import fast

    old, fast._F_FINDER = fast._F_FINDER, value
    try:
        yield
    finally:
        fast._F_FINDER = old


def _short_ext_err(p, inp, n, content=False) -> int:
    """K4 (K4x: ``content``) against its plain version with the word
    extension cut to 8 bytes (the port's CPX_SORT_EXT, read at import, set
    for the call and restored): the final stage's diagonal-run scan."""
    from comprox_tpu_torch.codec import block as blk

    old, blk._SORT_EXT = blk._SORT_EXT, 8
    try:
        if blk.sort_ext(p) >= blk._len_cap(p):
            raise AssertionError("CPX_SORT_EXT=8 must fall short of the cap")
        return max_err([(blk.sort_candidates(p, inp, n, content),
                         blk.sort_candidates_plain(p, inp, n, content))])
    finally:
        blk._SORT_EXT = old


class Phases:
    def __init__(self):
        self.n = 0

    def run(self, name, fn, *args):
        self.n += 1
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {self.n} {name}: {time.perf_counter() - t0:.3f} s",
              flush=True)
        return out


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


# ptxas's lines for an entry function, in a verbose build's output
_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
# the reported arms, by the identifier in a mangled entry name (its length,
# then itself, then the template arguments: ints Li..E, bools Lb..E)
_ARM_PARAMS = {"k1_kernel": ("MAXT", "CL"), "k12d_kernel": ("MAXT", "MODE", "CL", "BLK"),
               "k2_kernel": ("MAXT", "MODE", "CL", "LPR"),
               "k5_kernel": ("MAXT", "CL", "TPL", "CHAIN"), "k6_kernel": ("FAST", "KG"),
               "k11_kernel": (), "k3_kernel": ("NS",), "k3p_kernel": (),
               "k4_find": ("NC",), "k4_heads": ("NC",), "k4_final": ("NC", "WALK"),
               "k3b_pass": (), "k9_events": (),
               "pr_row_gather": ("VEC",), "pr_steps": (), "pr_row_bulk": (),
               "pr_row_ring": ("DEPTH",), "pr_onehot_wgmma": ()}
_MANGLED = re.compile(r"_ZN(\d+)")
_ARM_ARG = re.compile(r"L[ib](\d+)E")


def _arm_name(fn: str):
    """``k2_kernel<MAXT=512, MODE=R, CL=0, LPR=4>`` for a mangled entry
    function of an arm this build reports (and each K13c kernel), None for
    any other.  The name is nested in the source's anonymous namespace:
    ``_ZN`` <length> <namespace> <length> <identifier> [template args]."""
    m = _MANGLED.match(fn)
    if not m:
        return None
    at = m.end() + int(m.group(1))
    m = re.match(r"(\d+)", fn[at:])
    if not m:
        return None
    name = fn[at + m.end(): at + m.end() + int(m.group(1))]
    if name.startswith("k13c_"):
        return name
    if name not in _ARM_PARAMS:
        return None
    rest = fn[at + m.end() + len(name):]
    args = _ARM_ARG.findall(rest[: rest.find("EE") + 1]) if rest.startswith("I") else []
    shown = ", ".join(f"{k}={'RXP'[int(v)] if k == 'MODE' else v}"
                      for k, v in zip(_ARM_PARAMS[name], args))
    return f"{name}<{shown}>" if shown else name


def _arms(log: str) -> list:
    """(library, kernel arm, registers, spill stores, spill loads) of each
    step scan's and per-lane pass's arm, each K13c kernel and the probes'
    flat gather, steps, bulk-copy, ring and wgmma kernels in a verbose
    build's output."""
    out, lib, fn, spill = [], "", None, (0, 0)
    for line in log.splitlines():
        if line.startswith("libcpx_kernels_"):
            lib = line.split()[0]
        m = _PTXAS_ENTRY.search(line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = _PTXAS_SPILL.search(line)
        if m and fn:
            spill = (int(m.group(2)), int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m and fn:
            name = _arm_name(fn)
            if name:
                out.append((lib, name, int(m.group(1)), *spill))
            fn = None
    return out


def phase_build():
    from comprox_tpu_torch.benchmarks import phases
    from comprox_tpu_torch.utils import build

    depths = (0, phases.default_depth())
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        libs = build.build_many([((), None)] + phases.variant_specs(depths), verbose=True)
    print(log.getvalue())
    print(f"kernels: {libs[0]}; the decode scans' instrumented builds (K1, "
          f"K12d, K13d; ring depth {depths[0]}, {depths[1]}): "
          f"{', '.join(p.name for p in libs[1:3])}; K5's and the modeling scan's: "
          f"{libs[3].name}")
    for lib, name, regs, stores, loads in _arms(log.getvalue()):
        tag = "main" if lib == libs[0].name else "instrumented"
        print(f"registers ({tag} build): {name}: {regs} registers, "
              f"{stores} B spill stores, {loads} B spill loads")
    build.lib()


def _check_launched(name, step, bp):
    """Fails if ``step`` launched no kernel.  For a block of more lanes than
    a CTA has threads (the step scans run as a cluster), prints each
    kernel's device microseconds per step of a block."""
    from comprox_tpu_torch.codec import block as blk

    if not any(blk.LAUNCHES.values()):
        raise AssertionError(f"{name}: {step} launched no kernel")
    if bp.lanes > 1024:
        ms = blk.kernel_ms()
        per = {k: round(ms[k] * 1e3 / (n * bp.steps), 1)
               for k, n in blk.LAUNCHES.items() if n}
        print(f"{name}: {step}, S={bp.lanes}, device us per step: {json.dumps(per)}")


def phase_golden():
    """Decode the JAX archives on the card; re-encode each corpus that no
    full-width phase codes, under its archive's command line.  Returns
    {archive name: decoded corpus bytes}."""
    import numpy as np

    from comprox_tpu_torch.cli.main import make_params, parse_args
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.codec.container import decode_stream, encode_stream

    meta = json.loads((GOLDEN / "torch_golden.json").read_text())
    corpora = {}
    for name, m in sorted(meta.items()):
        if name in GROUP_GOLDENS:  # phase_golden_groups decodes them
            continue
        arc = (GOLDEN / name).read_bytes()
        if sha256(arc) != m["archive_sha256"]:
            raise AssertionError(f"{name}: fixture does not match its digest")
        argv = m["argv"].split()  # [KNOB=value] codec e [switches]
        env = dict(a.split("=") for a in argv if "=" in a)
        codec, _, _, _, opts = parse_args(
            [a for a in argv if "=" not in a] + ["in", "out"])
        cp = make_params(codec, opts)
        blk.reset_launch_counts()
        out = io.BytesIO()
        t0 = time.perf_counter()
        decode_stream(io.BytesIO(arc), out, "cuda")
        t_dec = time.perf_counter() - t0
        raw = out.getvalue()
        if len(raw) != m["input_bytes"] or sha256(raw) != m["input_sha256"]:
            raise AssertionError(f"{name}: decoded bytes differ from the input")
        _check_launched(name, "decode", cp.block)
        print(f"{name}: JAX archive decoded on the card ({t_dec:.2f} s)")
        corpora[name] = np.frombuffer(raw, np.uint8)
        if name in FULL_WIDTH_ARCHIVES:
            continue
        buf = io.BytesIO()
        blk.reset_launch_counts()
        t0 = time.perf_counter()
        with finder_knob("CPX_X_FINDER", env.get("CPX_X_FINDER", "sort")), \
                f_finder_knob(env.get("CPX_F_FINDER", "sort")):
            encode_stream(corpora[name], buf, cp, "cuda", filters=opts["filters"],
                          chain=opts["chain"])
        t_enc = time.perf_counter() - t0
        _check_launched(name, "encode", cp.block)
        got = buf.getvalue()
        if sha256(got) != m["archive_sha256"]:
            raise AssertionError(f"{name}: port archive differs from JAX's")
        print(f"{name}: port archive {len(got)} B ({m['argv']}), sha256 == JAX "
              f"golden ({t_enc:.2f} s)")
    return corpora


def _tables_pairs(ta, tb_):
    return [(ta[k], tb_[k]) for k in ta]


def _touched_bytes(final, init) -> int:
    """Bytes of a table updated in place that this run's data needed: the
    rows that differ from the initial table, read once and written once."""
    f = final.reshape(final.shape[0], -1)
    rows = int((f != init.reshape(f.shape)).any(dim=1).sum())
    return 2 * rows * f.shape[1] * final.element_size()


def _timed_plain(fn, *args):
    """One run of a plain version on the card: (result, host-clock ms)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _kernel_ms(name, make_args, fn, reps=3):
    """Mean CUDA-event time of ``reps`` launches through the wrapper."""
    from comprox_tpu_torch.codec import block as blk

    blk.reset_launch_counts()
    arg_sets = [make_args() for _ in range(reps)]
    for a in arg_sets:
        fn(*a)
    ms = blk.kernel_ms()[name] / reps
    if blk.LAUNCHES[name] != reps:
        raise AssertionError(f"{name}: {blk.LAUNCHES[name]} launches")
    return ms


def _event_ms(fn, reps=3):
    import torch

    fn()  # warm up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _record(res, name, err, ms, plain_ms, nbytes, ops, library_ms=None):
    """A kernel's line; its bound from its bytes and operations (the
    models of comprox_tpu_torch/benchmarks/work.py, which ``phases`` also
    counts with)."""
    from comprox_tpu_torch.benchmarks import work

    bound_ms, bound_by = work.bound(nbytes, ops)
    res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms)


def _stream_of(n_words, stream):
    """K3b's result with the stream past each block's n_words zeroed (the
    card leaves it as it found it): what a comparison holds."""
    import torch

    keep = torch.arange(stream.shape[-1], device=stream.device) < n_words.unsqueeze(-1)
    return n_words, torch.where(keep, stream, 0)


def _k3b_cell(res, name, packed, emit, words):
    """K3b on K3p's ``packed`` mask and K3's ``words`` against its plain
    version, tolerance 0 on the count and the stream; ``words[emit]`` (one
    ``masked_select``, never on the path) timed beside."""
    from comprox_tpu_torch.benchmarks import work
    from comprox_tpu_torch.codec import block as blk

    got = _stream_of(*blk.compact_stream(packed, words))
    want, plain_ms = _timed_plain(blk.compact_stream_plain, packed, words)
    err = max_err(zip(got, want))
    ms = _kernel_ms("K3b", lambda: (packed, words), blk.compact_stream)
    lib_ms = _event_ms(lambda: words[emit])
    _record(res, name, err, ms, plain_ms, *work.k3b(packed, words, out=got),
            library_ms=lib_ms)


def phase_kernels(corpus):
    """Each kernel against its plain version on the card.  Returns
    {name: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms)}.

    The bound counts each input read once and each output written once (of
    a table updated in place: the rows this run changed, both ways), and a
    model of the 32-bit operations the function needs on these inputs,
    stated in comprox_tpu_torch/benchmarks/work.py; the scans' T dependent
    steps are what keeps them far from it."""
    import numpy as np
    import torch

    from comprox_tpu_torch.benchmarks import phases, work
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.models import ppm

    dev = "cuda"
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="R", min_len=5,
                        window=250, rolz_ctx_bytes=4, rolz_dec=2)
    n = p.capacity
    data = corpus[:n]
    inp = torch.from_numpy(data.reshape(p.lanes, p.steps).copy()).to(dev)
    res = {}
    def rolz0():
        return blk._init_rolz(p, dev)

    def tables0():
        return ppm.init_tables(True, p.o3_bits, dev)

    def record(*args, **kw):
        _record(res, *args, **kw)

    # KS.
    rk, rp = rolz0(), rolz0()
    blk.reset_launch_counts()
    gk = blk.search_scan(p, inp, n, rk)
    if blk.LAUNCHES["KS"] != 1:
        raise AssertionError("KS did not launch")
    gp, plain_ms = _timed_plain(blk.search_scan_plain, p, inp, n, rp)
    err = max_err([(gk, gp), (rk, rp)])
    ms = _kernel_ms("KS", lambda: (p, inp, n, rolz0()), blk.search_scan)
    record("KS", err, ms, plain_ms,
           work.nbytes(inp, gk) + _touched_bytes(rk, rolz0()), work.scan_ops("KS", p))

    # K4 at this window, and with the extension cut short.
    propk = blk.sort_candidates(p, inp, n)
    propp, plain_ms = _timed_plain(blk.sort_candidates_plain, p, inp, n)
    err = max(max_err([(propk, propp)]), _short_ext_err(p, inp, n))
    ms = _kernel_ms("K4", lambda: (p, inp, n), blk.sort_candidates)
    record("K4", err, ms, plain_ms, *work.k4(p, inp, n, out=propk))
    k4_small = dict(res["K4"])

    # K5, on the finder's proposals.
    rk, rp = rolz0(), rolz0()
    ck = blk.rank_scan(p, inp, n, propk, rk)
    cp, plain_ms = _timed_plain(blk.rank_scan_plain, p, inp, n, propk, rp)
    err = max_err([(ck, cp), (rk, rp)])
    ms = _kernel_ms("K5", lambda: (p, inp, n, propk, rolz0()), blk.rank_scan)
    record("K5", err, ms, plain_ms,
           work.nbytes(inp, propk, ck) + _touched_bytes(rk, rolz0()),
           work.scan_ops("K5", p, ck))

    # K6, on the rank scan's candidates.
    dk = blk.parse_scan(p, n, ck)
    dp, plain_ms = _timed_plain(blk.parse_scan_plain, p, n, ck)
    err = max_err([(dk, dp)])
    ms = _kernel_ms("K6", lambda: (p, n, ck), blk.parse_scan)
    record("K6", err, ms, plain_ms, *work.k6(p, n, ck, out=dk))

    # K2, on the flexible parse's decisions.
    tk, tp = tables0(), tables0()
    evk = blk.model_scan(p, inp, n, dk, tk)
    evp, plain_ms = _timed_plain(blk.model_scan_plain, p, inp, n, dk, tp)
    err = max_err([(evk, evp)] + _tables_pairs(tk, tp))
    ms = _kernel_ms("K2", lambda: (p, inp, n, dk, tables0()), blk.model_scan)
    t0_ = tables0()
    tab_bytes = sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
    record("K2", err, ms, plain_ms, work.nbytes(inp, dk, evk) + tab_bytes,
           work.scan_ops("K2", p))

    # K3.
    sk, ek, wk = blk.rans_scan(p, evk)
    (sp, ep, wp), plain_ms = _timed_plain(blk.rans_scan_plain, p, evk)
    err = max_err([(sk, sp), (ek, ep), (wk, wp)])
    ms = _kernel_ms("K3", lambda: (p, evk), blk.rans_scan)
    record("K3", err, ms, plain_ms, *work.k3(p, evk, out=(sk, ek, wk)))
    _k3b_cell(res, "K3b", blk.pack_emit(p, ek), ek, wk)

    # K1, on the payload the kernels wrote.  Bytes: the words the stream
    # holds.
    payload = blk._pack_payload(sk, blk.pack_emit(p, ek), wk)
    n_words, st, stream = blk._unpack_payload(payload, p)
    st_t = torch.from_numpy(st.astype(np.int64)).to(dev)
    stream_t = torch.from_numpy(stream.astype(np.int32)).to(dev)
    tk, tp, rk, rp = tables0(), tables0(), rolz0(), rolz0()
    xk, uk, ok = blk.decode_scan(p, st_t, stream_t, n, tk, rk)
    (xp, up, op), plain_ms = _timed_plain(
        blk.decode_scan_plain, p, st_t, stream_t, n, tp, rp)
    if uk != up:
        raise AssertionError(f"K1 words used {uk} vs plain {up}")
    err = max_err([(xk, xp), (ok, op), (rk, rp)] + _tables_pairs(tk, tp))
    blk._check_drain(xk.cpu().numpy(), uk, n_words)
    if not np.array_equal(ok.cpu().numpy().reshape(-1), data):
        raise AssertionError("K1 did not decode the block")
    ms = _kernel_ms(
        "K1", lambda: (p, st_t, stream_t, n, tables0(), rolz0()),
        blk.decode_scan)
    tab_bytes = sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
    record("K1", err, ms, plain_ms,
           4 * n_words + work.nbytes(st_t, ok) + tab_bytes
           + _touched_bytes(rk, rolz0()), work.scan_ops("K1", p))

    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']} (tolerance 0)  kernel "
              f"{r['ms']:.3f} ms ({r['ms'] * 1e3 / p.steps:.1f} us/step)  "
              f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  [S={p.lanes} T={p.steps} full tables]")

    # K4 at the main path's size: the whole 8 MiB corpus as one block, with
    # its sort stage beside torch.sort (stable) on the same keys.
    pf = blk.BlockParams(lanes=512, steps=corpus.size // 512, mode="R",
                         min_len=5, window=250, rolz_ctx_bytes=4, rolz_dec=2)
    nf = pf.capacity
    inpf = torch.from_numpy(corpus[:nf].reshape(pf.lanes, pf.steps).copy()).to(dev)
    propk = blk.sort_candidates(pf, inpf, nf)
    propp, plain_ms = _timed_plain(blk.sort_candidates_plain, pf, inpf, nf)
    err = max_err([(propk, propp)])
    del propp
    short_err = _short_ext_err(pf, inpf, nf)
    ms = _kernel_ms("K4", lambda: (pf, inpf, nf), blk.sort_candidates)
    stages = phases.k4_stages(pf, inpf, nf)
    bytes_pad = blk.pad_block(pf, inpf)
    keys = blk.sort_keys_plain(pf, bytes_pad, nf)
    hs, ps, passes = blk.sort_positions(pf, bytes_pad, nf, with_passes=True)
    hp, pp = torch.sort(keys, stable=True)
    err = max(err, max_err([(hs, hp), (ps, pp)]))
    sort_ms = _event_ms(lambda: blk.sort_positions(pf, bytes_pad, nf))
    lib_ms = _event_ms(lambda: torch.sort(keys, stable=True))
    lib32_ms = _event_ms(lambda: torch.sort(keys.to(torch.int32), stable=True))
    record("K4", max(err, short_err, k4_small["max_abs_err"]), ms, plain_ms,
           *work.k4(pf, inpf, nf, out=propk), library_ms=lib_ms)
    r = res["K4"]
    print(f"K4 at N={nf} (S=512 T={pf.steps}): max_abs_err {err}  kernel "
          f"{ms:.3f} ms  plain {plain_ms:.3f} ms  bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); its sort stage (keys + {passes} radix passes) "
          f"{sort_ms:.3f} ms, torch.sort(stable) of the same keys as int64 "
          f"{lib_ms:.3f} ms, as int32 bit patterns {lib32_ms:.3f} ms; at "
          f"T={KERNEL_STEPS}: kernel {k4_small['ms']:.3f} ms, plain "
          f"{k4_small['plain_ms']:.3f} ms; CPX_SORT_EXT=8 (the final stage's "
          f"scan arm): max_abs_err {short_err} at N={nf}, "
          f"{k4_small['max_abs_err']} at T={KERNEL_STEPS} with the default's")
    print(phases.k4_stage_line(f"K4 at N={nf}", stages))
    for name, r in res.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(
                f"{name}: kernel != plain (max err {r['max_abs_err']})")
    return res


def phase_kernels_chain(corpus):
    """KCR, K3p and the chain arms of K5 and K1 against their plain versions
    on the card, at S=512, T=256, full tables, from a real carried state:
    the state after one block of the corpus' first S*T bytes, then the next
    S*T bytes; tolerance 0 on every grid and table.  The unchained arms'
    ms (K5, K1) on the same block beside.  Returns the per-kernel dicts of
    phase_kernels."""
    import dataclasses

    import numpy as np
    import torch

    from comprox_tpu_torch.benchmarks import work
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.models import ppm

    dev = "cuda"
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="R", min_len=5,
                        window=250, rolz_ctx_bytes=4, rolz_dec=2, chain_match=True)
    pu = dataclasses.replace(p, chain_match=False)
    n = p.capacity
    _, st = blk.encode_block_chained(corpus[:n], p, blk.init_chain_tables(p, dev), dev)
    data = corpus[n:2 * n]
    inp = torch.from_numpy(data.reshape(p.lanes, p.steps).copy()).to(dev)
    prev = st["prev"]
    res, beside = {}, {}

    def record(*args, **kw):
        _record(res, *args, **kw)

    def tables0():
        return {k: v.clone() for k, v in st["tables"].items()}

    # KCR on the carried table.
    mk = blk.remap_chain_ment(p, st["ment"])
    mp, plain_ms = _timed_plain(blk.remap_chain_ment_plain, p, st["ment"])
    err = max_err([(mk, mp)])
    ms = _kernel_ms("KCR", lambda: (p, st["ment"]), blk.remap_chain_ment)
    record("KCR", err, ms, plain_ms, *work.kcr(p, st["ment"], out=mk))
    # The same launches as decode makes them, after the host's unpacking of
    # the payload: with the stream idle before each, after 100 ms of an
    # idle card, and into an output the allocator must get anew.
    def kcr_after(prep):
        blk.reset_launch_counts()
        for _ in range(3):
            prep()
            blk.remap_chain_ment(p, st["ment"])
        return blk.kernel_ms()["KCR"] / 3

    def rest():
        torch.cuda.synchronize()
        time.sleep(0.1)

    def fresh():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    print(f"KCR, ms a launch: {ms:.4f} behind queued launches, "
          f"{kcr_after(torch.cuda.synchronize):.4f} with the stream idle before "
          f"each, {kcr_after(rest):.4f} after 100 ms of an idle card, "
          f"{kcr_after(fresh):.4f} into a fresh allocation")

    # K5's chain arm, on the finder's proposals of the second block.
    propk = blk.sort_candidates(p, inp, n)
    rk, rp = mk.clone(), mk.clone()
    ck = blk.rank_scan(p, inp, n, propk, rk, prev)
    cp, plain_ms = _timed_plain(blk.rank_scan_plain, p, inp, n, propk, rp, prev)
    err = max_err([(ck, cp), (rk, rp)])
    ms = _kernel_ms("K5ch", lambda: (p, inp, n, propk, mk.clone(), prev), blk.rank_scan)
    record("K5ch", err, ms, plain_ms,
           work.nbytes(inp, prev, propk, ck) + _touched_bytes(rk, mk),
           work.scan_ops("K5ch", p, ck))
    beside["K5"] = _kernel_ms("K5", lambda: (pu, inp, n, propk, blk._init_rolz(pu, dev)),
                              blk.rank_scan)

    # K3p on K3's mask of the second block (the chained encode).
    dk = blk.parse_scan(p, n, ck)
    evk = blk.model_scan(p, inp, n, dk, tables0())
    sk, ek, wk = blk.rans_scan(p, evk)
    pk = blk.pack_emit(p, ek)
    pp, plain_ms = _timed_plain(blk.pack_emit_plain, ek)
    err = max_err([(pk, pp)])
    ms = _kernel_ms("K3p", lambda: (p, ek), blk.pack_emit)
    record("K3p", err, ms, plain_ms, *work.k3p(p, ek, out=pk))

    # K1's chain arm, on that block's payload.  Bytes: the words the stream
    # holds, the states, the window's first region, the output, the table
    # rows it changed.
    payload = blk._pack_payload(sk, pk, wk)
    n_words, stt, stream = blk._unpack_payload(payload, p)
    st_t = torch.from_numpy(stt.astype(np.int64)).to(dev)
    stream_t = torch.from_numpy(stream.astype(np.int32)).to(dev)
    tk, tp, rk, rp = tables0(), tables0(), mk.clone(), mk.clone()
    xk, uk, ok = blk.decode_scan(p, st_t, stream_t, n, tk, rk, prev=prev)
    (xp, up, op), plain_ms = _timed_plain(
        blk.decode_scan_plain, p, st_t, stream_t, n, tp, rp, None, prev)
    if uk != up:
        raise AssertionError(f"K1ch words used {uk} vs plain {up}")
    err = max_err([(xk, xp), (ok, op), (rk, rp)] + _tables_pairs(tk, tp))
    blk._check_drain(xk.cpu().numpy(), uk, n_words)
    if not np.array_equal(ok.cpu().numpy().reshape(-1), data):
        raise AssertionError("K1ch did not decode the block")
    ms = _kernel_ms("K1ch", lambda: (p, st_t, stream_t, n, tables0(), mk.clone(), None,
                                     prev), blk.decode_scan)
    t0_ = tables0()
    tab_bytes = sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
    record("K1ch", err, ms, plain_ms,
           4 * n_words + work.nbytes(st_t, prev, ok) + tab_bytes + _touched_bytes(rk, mk),
           work.scan_ops("K1ch", p))
    payload_u = blk.encode_block(data, pu, dev)
    nu, stu, streamu = blk._unpack_payload(payload_u, pu)
    stu_t = torch.from_numpy(stu.astype(np.int64)).to(dev)
    streamu_t = torch.from_numpy(streamu.astype(np.int32)).to(dev)
    beside["K1"] = _kernel_ms(
        "K1", lambda: (pu, stu_t, streamu_t, n, ppm.init_tables(True, pu.o3_bits, dev),
                       blk._init_rolz(pu, dev)), blk.decode_scan)

    for name, r in res.items():
        arm = {"K5ch": "K5", "K1ch": "K1"}.get(name)
        print(f"{name}: max_abs_err {r['max_abs_err']} (tolerance 0)  kernel "
              f"{r['ms']:.3f} ms ({r['ms'] * 1e3 / p.steps:.1f} us/step)  "
              f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})" + (f"  unchained {arm} {beside[arm]:.3f} ms" if arm else "")
              + f"  [S={p.lanes} T={p.steps} full tables, the state one block leaves]")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name}: kernel != plain (max err {r['max_abs_err']})")
    return res


def phase_sort(corpus):
    """The shared radix sort against torch.sort(stable=True) on the
    adversarial key sets and on K4's keys of the 8 MiB corpus; returns its
    record for the kernels line (timed on those keys, the main path's)."""
    import torch

    from comprox_tpu_torch.benchmarks import sort_keys, work
    from comprox_tpu_torch.codec import block as blk

    dev = "cuda"
    err = 0
    for name in sort_keys.SETS:
        keys = sort_keys.keys(name).to(dev)
        hs, ps, passes = blk.radix_sort(keys)
        hp, pp = torch.sort(keys, stable=True)
        e = max_err([(hs, hp), (ps, pp)])
        want = blk.radix_passes_plain(keys)
        if passes != want:
            raise AssertionError(f"sort {name}: {passes} passes, digits that vary {want}")
        print(f"sort {name}: N={keys.numel()} max_abs_err {e} (tolerance 0) "
              f"passes {passes}")
        err = max(err, e)
    pf = blk.BlockParams(lanes=512, steps=corpus.size // 512, mode="R",
                         min_len=5, window=250, rolz_ctx_bytes=4, rolz_dec=2)
    n = pf.capacity
    inp = torch.from_numpy(corpus[:n].reshape(pf.lanes, pf.steps).copy()).to(dev)
    keys = blk.sort_keys_plain(pf, blk.pad_block(pf, inp), n)
    k32 = torch.where(keys >= 1 << 31, keys - (1 << 32), keys).to(torch.int32)
    key = torch.empty((2, n), dtype=torch.int32, device=dev)
    pos = torch.empty_like(key)
    reps = 5
    key[0].copy_(k32)
    blk._radix_sort(key, pos, n)  # warm-up
    blk.reset_launch_counts()
    for _ in range(reps):
        key[0].copy_(k32)  # the input again: each launch sorts K4's keys
        passes = blk._radix_sort(key, pos, n)
    ms = blk.kernel_ms()["SORT"] / reps
    (hp, pp), plain_ms = _timed_plain(lambda: torch.sort(keys, stable=True))
    err = max(err, max_err([(key[0].long() & 0xFFFFFFFF, hp), (pos[0], pp)]))
    lib_ms = _event_ms(lambda: torch.sort(keys, stable=True))
    lib32_ms = _event_ms(lambda: torch.sort(k32, stable=True))
    passes = int(passes.item())
    # The design's own floor, each pass reading and writing 8 bytes a key
    # and the histograms reading the keys once, is printed beside the bound.
    res = {}
    _record(res, "SORT", err, ms, plain_ms, *work.sort(key, pos, n, out=passes),
            library_ms=lib_ms)
    r = res["SORT"]
    floor_ms = (16 * passes + 4) * n / work.PEAK_BYTES_PER_S * 1e3
    print(f"sort of K4's keys, N={n}: max_abs_err {err}  kernel {ms:.3f} ms "
          f"({passes} passes)  plain (torch.sort, host clock) {plain_ms:.3f} ms  "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {passes} passes of "
          f"this design {floor_ms:.4f} ms); torch.sort(stable) of the same keys "
          f"as int64 {lib_ms:.3f} ms, as int32 bit patterns {lib32_ms:.3f} ms; "
          f"kernel / torch.sort {ms / lib_ms:.2f}")
    if err != 0:
        raise AssertionError(f"SORT: kernel != torch.sort (max err {err})")
    return res


def phase_scan_phases():
    """The step scans by phase: the 8 MiB flexible crz archive decoded
    through K1's two instrumented builds of phase 2 (ring depth 0 and the
    build's depth), its corpus encoded through K5's and K2's, the 8 MiB
    crx and crp archives decoded through K12d's and K13d's (the same two
    builds) and their corpora encoded through K12e's and K13e's, and the 8
    MiB crz ``-f0`` and crx scan-finder corpora through KS's and KSx's."""
    from comprox_tpu_torch.benchmarks import phases

    phases.run(GOLDEN / MAIN_ARCHIVE, ("K1", "K5", "K2", "K12e", "K13e", "K12d", "K13d",
                                       "KS", "KSx"),
               (0, phases.default_depth()),
               archives={"K12d": GOLDEN / X_ARCHIVE, "K13d": GOLDEN / P_ARCHIVE,
                         "K12e": GOLDEN / X_ARCHIVE, "K13e": GOLDEN / P_ARCHIVE})


def phase_kernels_fast(corpus):
    """The mode-F kernels against their plain versions on the card, on the
    whole 8 MiB corpus as one block (S=512, T=16384, n = N).  Returns the
    same per-kernel dicts as phase_kernels for K7-K10, and K6's F entry
    under "K6F"."""
    import numpy as np
    import torch

    from comprox_tpu_torch.benchmarks import work
    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.codec import fast

    dev = "cuda"
    p = make_params("crf", {"lanes": 512, "block_mb": 8}).block
    big = n = p.capacity
    if corpus.size != big:
        raise AssertionError(f"corpus of {corpus.size} B for a block of {big}")
    inp = torch.from_numpy(corpus.reshape(p.lanes, p.steps).copy()).to(dev)
    n_c = fast._F_CANDS
    res = {}

    # K7 at N = 8 Mi: on the corpus, on an all-zero block (one key over
    # every sort tile, runs to the cap) and with the word extension cut to
    # 8 bytes (CPX_F_EXTW=3: the final stage's runs supply every longer
    # length); its stages beside.
    from comprox_tpu_torch.benchmarks import phases

    ck = fast.f2_find(p, inp, n)
    cp, plain_ms = _timed_plain(fast.f2_find_plain, p, inp, n)
    err = max_err([(ck, cp)])
    del cp
    zeros = torch.zeros_like(inp)
    err_zero = max_err([(fast.f2_find(p, zeros, n), fast.f2_find_plain(p, zeros, n))])
    del zeros
    old, fast._EXTW = fast._EXTW, 3
    try:
        err_ext = max_err([(fast.f2_find(p, inp, n), fast.f2_find_plain(p, inp, n))])
    finally:
        fast._EXTW = old
    print(f"K7 at N={big}: max_abs_err on an all-zero block {err_zero}, at "
          f"CPX_F_EXTW=3 {err_ext} (tolerance 0)")
    err = max(err, err_zero, err_ext)
    ms = _kernel_ms("K7", lambda: (p, inp, n), fast.f2_find)
    print(phases.k4_stage_line("K7", phases.kernel_stages("K7", p, inp, n)))
    bytes_pad = fast.pad_block(p, inp)
    keys = fast.sort_keys_plain(p, bytes_pad, n)
    hs, ps, passes = fast.sort_positions(p, bytes_pad, n, with_passes=True)
    hp, pp = torch.sort(keys, stable=True)
    err = max(err, max_err([(hs, hp), (ps, pp)]))
    del hs, ps, hp, pp
    sort_ms = _event_ms(lambda: fast.sort_positions(p, bytes_pad, n))
    lib_ms = _event_ms(lambda: torch.sort(keys, stable=True))
    del keys
    _record(res, "K7", err, ms, plain_ms, *work.k7(p, inp, n, out=ck), library_ms=lib_ms)
    print(f"K7 at N={big}: max_abs_err {err}  kernel {ms:.3f} ms  plain "
          f"{plain_ms:.3f} ms  bound {res['K7']['bound_ms']:.4f} ms "
          f"({res['K7']['bound_by']}); its sort stage (keys + {passes} radix "
          f"passes) {sort_ms:.3f} ms, torch.sort(stable) of the same keys "
          f"(int64) {lib_ms:.3f} ms")

    # K6, F entry, at T=256 on the finder's candidates of the first S * 256
    # bytes.
    ps_ = blk.BlockParams(lanes=p.lanes, steps=KERNEL_STEPS, mode="F",
                          min_len=p.min_len, window=p.window)
    ns = ps_.capacity
    inps = torch.from_numpy(corpus[:ns].reshape(ps_.lanes, ps_.steps).copy()).to(dev)
    cs = fast.f2_find(ps_, inps, ns)
    kw = dict(prices=fast._F_PRICES, n_c=n_c)
    dk = blk.parse_scan(ps_, ns, cs, **kw)
    dp, plain_ms = _timed_plain(lambda: blk.parse_scan_plain(ps_, ns, cs, **kw))
    err = max_err([(dk, dp)])
    ms = _kernel_ms("K6", lambda: (ps_, ns, cs), lambda *a: blk.parse_scan(*a, **kw))
    # (The F entry's third grid is all zero and nothing reads it.)
    _record(res, "K6F", err, ms, plain_ms, *work.k6(ps_, ns, cs, out=dk, **kw))
    r = res["K6F"]
    print(f"K6, F entry at T={KERNEL_STEPS}: max_abs_err {err}  kernel {ms:.3f} ms "
          f"({ms * 1e3 / KERNEL_STEPS:.1f} us/step)  plain {plain_ms:.3f} ms  bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})")

    # K8 at N = 8 Mi, each input against the plain version (the plain
    # version also lines the other positions up behind the tokens, as JAX
    # does; the kernel's n_tok tokens are held against its first n_tok):
    # the kernel parse's decisions on the corpus (the plain parse takes ~3
    # ms a step), on an all-zero block (every take at the cap) and on the
    # corpus 1003 bytes short; then synthetic decisions on the corpus' bytes:
    # take 2 everywhere, takes of 250 across every chunk boundary, random
    # takes in [0, 250] capped at each lane's end.
    def k8_err(inp_, n_, dec_):
        got = fast.tokenize(p, inp_, n_, dec_)
        want, pms = _timed_plain(fast.tokenize_plain, p, inp_, n_, dec_)
        if got[0] != want[1]:
            raise AssertionError(f"K8 n_tok {got[0]} vs plain {want[1]}")
        return max_err([(a, b[: got[0]]) for a, b in zip(got[1:], want[2:])]), pms

    dec = blk.parse_scan(p, n, ck, **kw)
    n_tok, sym, xtr, tbits = fast.tokenize(p, inp, n, dec)
    err, plain_ms = k8_err(inp, n, dec)
    errs = {}
    zeros = torch.zeros_like(inp)
    errs["all-zero block"] = k8_err(zeros, n, blk.parse_scan(
        p, n, fast.f2_find(p, zeros, n), **kw))[0]
    del zeros
    n_short = n - 1003
    short = inp.clone()
    short.view(-1)[n_short:] = 0
    errs["1003 bytes short"] = k8_err(short, n_short, blk.parse_scan(
        p, n_short, fast.f2_find(p, short, n_short), **kw))[0]
    del short
    rng = np.random.default_rng(17)
    i32 = torch.int32
    left = torch.arange(p.steps, 0, -1, device=dev, dtype=i32)[:, None]
    pos = (torch.arange(p.lanes, device=dev, dtype=i32)[None, :] * p.steps
           + torch.arange(p.steps, device=dev, dtype=i32)[:, None])
    back = torch.from_numpy(rng.choice(np.array([1, 3, 7, 100, 5000], np.int32),
                                       (p.steps, p.lanes))).to(dev)
    for label, take in (
            ("take 2", torch.full((p.steps, p.lanes), 2, dtype=i32, device=dev)),
            ("take 250", torch.full((p.steps, p.lanes), 250, dtype=i32, device=dev)),
            ("random takes", torch.minimum(torch.from_numpy(rng.integers(
                0, 251, (p.steps, p.lanes), dtype=np.int32)).to(dev), left))):
        errs[label] = k8_err(inp, n, torch.stack([take, pos - back]))[0]
    print(f"K8 at N={big}: max_abs_err " + ", ".join(
        f"{k} {v}" for k, v in errs.items()) + " (tolerance 0)")
    err = max(err, *errs.values())
    ms = _kernel_ms("K8", lambda: (p, inp, n, dec), fast.tokenize)
    print(phases.k4_stage_line("K8", phases.kernel_stages("K8", p, inp, n)))
    starts = (dec[0].reshape(-1) > 0).to(torch.int32)  # an [N] int32 for the library scan
    lib_ms = _event_ms(lambda: torch.cumsum(starts, 0))
    _record(res, "K8", err, ms, plain_ms,
            *work.k8(p, inp, n, dec, out=(n_tok, sym, xtr, tbits)), library_ms=lib_ms)
    print(f"K8 at N={big}: {n_tok} tokens; max_abs_err {err}  kernel {ms:.3f} ms  "
          f"plain {plain_ms:.3f} ms  bound {res['K8']['bound_ms']:.4f} ms "
          f"({res['K8']['bound_by']}); one torch.cumsum over N int32 {lib_ms:.3f} ms "
          f"(the kernel's scan carries a count and a last nonzero value)")

    # K9 on the first S * 256 tokens.
    cut = min(n_tok, p.lanes * KERNEL_STEPS)
    ek = fast.encode_scan(p, sym, xtr, tbits, cut)
    ep, plain_ms = _timed_plain(fast.encode_scan_plain, p, sym, xtr, tbits, cut)
    err = max_err(list(zip(ek, ep)))
    ms = _kernel_ms("K9", lambda: (p, sym, xtr, tbits, cut), fast.encode_scan)
    full_ms = _kernel_ms("K9", lambda: (p, sym, xtr, tbits, n_tok), fast.encode_scan)
    sym64 = sym[:cut].long()
    lib_ms = _event_ms(lambda: torch.bincount(sym64, minlength=fast.W_SYM))
    _record(res, "K9", err, ms, plain_ms, *work.k9(p, sym, xtr, tbits, cut, out=ek),
            library_ms=lib_ms)
    print(f"K9 on {cut} tokens ({-(-cut // p.lanes)} steps): max_abs_err {err}  "
          f"kernel {ms:.3f} ms ({ms * 1e3 / -(-cut // p.lanes):.2f} us/step)  plain "
          f"{plain_ms:.3f} ms  bound {res['K9']['bound_ms']:.4f} ms "
          f"({res['K9']['bound_by']}); torch.bincount of the same symbols "
          f"{lib_ms:.3f} ms (the histogram alone); on all {n_tok} tokens: "
          f"kernel {full_ms:.3f} ms")
    print(phases.k4_stage_line("K9", phases.kernel_stages("K9", p, inp, n)))

    # K10 on the stream K9 writes for all n_tok tokens, zero-padded to
    # _max_words as decode_tokens pads it, and on the same stream cut to
    # its n_words words, where the last windows clamp (states, words used
    # and plane equal to the plain version's, whatever they are).  The
    # plain version's plane has JAX's N slots; the kernel's n_tok are its
    # first.
    freq, states, words = fast.encode_scan(p, sym, xtr, tbits, n_tok)
    stream = torch.zeros(fast._max_words(p), dtype=torch.int32, device=dev)
    stream[: words.numel()] = words
    xk, uk, plk = fast.decode_scan(p, freq, states, stream, n_tok)
    (xp, up, plp), plain_ms = _timed_plain(
        fast.decode_scan_plain, p, freq, states, stream, n_tok)
    if not uk == up == words.numel():
        raise AssertionError(f"K10 words used {uk} vs plain {up} of {words.numel()}")
    if not bool((xk == fast.RANS_L).all()):
        raise AssertionError("K10 did not drain the states")
    err = max_err([(xk, xp), (plk, plp[:n_tok])])
    out = (xk, uk, plk)
    clamped = words.contiguous()
    xc, uc, plc = fast.decode_scan(p, freq, states, clamped, n_tok)
    xp, up, plp = fast.decode_scan_plain(p, freq, states, clamped, n_tok)
    err_clamp = max(max_err([(xc, xp), (plc, plp[:n_tok])]), abs(uc - up))
    print(f"K10 on the stream cut to its {words.numel()} words: words used {uc}, "
          f"max_abs_err {err_clamp} (tolerance 0)")
    err = max(err, err_clamp)
    del xp, plp, clamped
    ms = _kernel_ms("K10", lambda: (p, freq, states, stream, n_tok), fast.decode_scan)
    print(phases.k4_stage_line("K10", phases.kernel_stages("K10", p, inp, n)))
    steps = -(-n_tok // p.lanes)
    _record(res, "K10", err, ms, plain_ms,
            *work.k10(p, freq, states, stream, n_tok, out=out))
    print(f"K10 on all {n_tok} tokens: max_abs_err {err}  kernel {ms:.3f} ms "
          f"({ms * 1e3 / steps:.2f} us/step, {ms * 1e6 / (3 * steps):.0f} ns an event)  "
          f"plain {plain_ms:.3f} ms  bound {res['K10']['bound_ms']:.4f} ms "
          f"({res['K10']['bound_by']})")
    for name, r in res.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(
                f"{name}: kernel != plain (max err {r['max_abs_err']})")
    return res


def _parse_case(rng, p, arm, max_len, ties=False):
    """Adversarial K6 inputs of one arm, numpy from ``rng`` (as
    tests/test_torch_parse_order.py makes them): the candidate grids, their
    count, the prices (None: mode R's) and the repeat pair (arm Xrep).
    Lengths up to ``max_len``, 40% of them 0; sources before and after the
    position and -1; with ``ties`` every candidate alike, each length 0 or
    the window's."""
    import numpy as np

    from comprox_tpu_torch.codec import block as blk

    shape = (p.steps, p.lanes)
    pos = np.arange(p.lanes)[None, :] * p.steps + np.arange(p.steps)[:, None]
    n_c, per = {"R": (5, 3), "F": (2, 2)}.get(arm, (3, 2))
    g = np.zeros((per * n_c + (arm == "R"), *shape), np.int32)
    for k in range(n_c):
        g[per * k] = rng.integers(0, max_len + 1, shape)
        g[per * k][rng.random(shape) < 0.4] = 0
        g[per * k + 1] = (rng.integers(-1, p.capacity, shape) if arm == "R"
                          else pos - rng.integers(-1, 700, shape))
        if arm == "R":
            g[3 * k + 2] = rng.integers(0, 40, shape)
    if arm == "R":
        g[15] = rng.integers(0, 17, shape)
    rep = None
    if arm == "Xrep":
        rep = np.stack([rng.integers(0, max_len + 1, shape),
                        rng.integers(1, 700, shape)]).astype(np.int32)
        rep[0][rng.random(shape) < 0.4] = 0
        if ties:
            rep[0] = np.where(rep[0] > 0, p.window, 0)
        same = rng.random(shape) < 0.3  # a normal candidate at the repeat distance
        g[1] = np.where(same, pos - rep[1], g[1])
    if ties:
        for k in range(1, n_c):
            g[per * k: per * k + per] = g[:per]
        g[0:per * n_c:per] = np.where(g[0:per * n_c:per] > 0, p.window, 0)
    prices = {"R": None, "F": (36, 40, 9)}.get(arm, blk.x_prices())
    return g, n_c, prices, rep


def phase_parse_cases():
    """K6, each arm (R, F, X without and with the repeat pair), and K11
    against their plain versions on the card on adversarial inputs (those
    of tests/test_torch_parse_order.py): dense random candidates with
    lengths past the window; every candidate tied at the window's length; a
    literal price of 300000 that drives the cost-to-go to its ceiling 2^22
    - 1 (the prices of test_parse_f_prices_and_saturation); min_len 1 (the
    candidates priced one step ahead); K11 on random decisions (copies
    started at changing distances inside runs) over bytes of long equal
    runs.  Two geometries: the kernel phases' S=512, T=256, window 250, and
    a ragged S=104, T=77, window 256 (K11's last CTA and both kernels'
    last tile of steps cut short), both 37 bytes short of the block.  Tolerance 0.  Returns the
    max abs err of "K6" (R, F), "K6 (X)" and "K11"."""
    import numpy as np
    import torch

    from comprox_tpu_torch.codec import block as blk

    dev = "cuda"
    errs = {"K6": 0, "K6 (X)": 0, "K11": 0}
    cases = 0
    for lanes, steps, window in ((512, KERNEL_STEPS, 250), (104, 77, 256)):
        for arm in ("R", "F", "X", "Xrep"):
            for case in ("random", "ties", "saturating", "min_len 1"):
                min_len = 1 if case == "min_len 1" else (5 if arm == "R" else 6)
                p = blk.BlockParams(lanes=lanes, steps=steps, window=window, min_len=min_len,
                                    mode="R" if arm == "R" else "X")
                rng = np.random.default_rng(cases)
                max_len = 12 if case == "saturating" else window + 3
                g, n_c, prices, rep = _parse_case(rng, p, arm, max_len, case == "ties")
                per = 3 if arm == "R" else 2
                old = blk._P_LIT_R
                if case == "saturating":
                    g[0:per * n_c:per][:, rng.random(g[0].shape) < 0.7] = 0
                    if rep is not None:
                        rep[0][rng.random(g[0].shape) < 0.9] = 0
                    if prices is None:
                        blk._P_LIT_R = 300000
                    else:
                        prices = (300000, 45, 9, 30)[:len(prices)]
                n = p.capacity - 37
                ct = torch.from_numpy(g).to(dev)
                rt = None if rep is None else torch.from_numpy(rep).to(dev)
                kw = {} if prices is None else dict(prices=prices, n_c=n_c)
                try:
                    got = blk.parse_scan(p, n, ct, rep=rt, **kw)
                    want = blk.parse_scan_plain(p, n, ct, rep=rt, **kw)
                finally:
                    blk._P_LIT_R = old
                err = max_err([(got, want)])
                row = "K6 (X)" if arm.startswith("X") else "K6"
                errs[row] = max(errs[row], err)
                if err:
                    raise AssertionError(f"K6 ({arm}, {case}, S={lanes}, T={steps}) differs "
                                         f"from its plain version: max abs err {err}")
                cases += 1
        p = blk.BlockParams(lanes=lanes, steps=steps, window=window, min_len=6, mode="X")
        for seed, name in enumerate(("zeros", "period7", "random")):
            rng = np.random.default_rng(100 + seed)
            n = p.capacity - 37
            data = np.zeros(p.capacity, np.uint8)
            data[:n] = {"zeros": np.zeros(n, np.uint8),
                        "period7": np.tile(rng.integers(0, 256, 7, dtype=np.uint8),
                                           n // 7 + 1)[:n],
                        "random": rng.integers(0, 2, n, dtype=np.uint8)}[name]
            shape = (p.steps, p.lanes)
            pos = np.arange(p.lanes)[None, :] * p.steps + np.arange(p.steps)[:, None]
            take = rng.integers(1, 9, shape).astype(np.int32)
            take[rng.random(shape) < 0.6] = 0
            dist = rng.choice(np.array([1, 2, 7, 14, p.steps + 1, 2 * p.steps]), shape)
            src = (pos - dist + (rng.random(shape) < 0.05) * 5 * p.steps).astype(np.int32)
            inp = torch.from_numpy(data.reshape(p.lanes, p.steps)).to(dev)
            dec = torch.from_numpy(np.stack([take, src])).to(dev)
            err = max_err([(blk.rep_scan(p, inp, n, dec), blk.rep_scan_plain(p, inp, n, dec))])
            errs["K11"] = max(errs["K11"], err)
            if err:
                raise AssertionError(f"K11 ({name}, S={lanes}, T={steps}) differs from its "
                                     f"plain version: max abs err {err}")
            cases += 1
    print(f"K6 and K11 cases: {cases} cases, each equal to its plain version; "
          f"max abs err {errs}")
    return errs


def phase_kernels_x(corpus):
    """The mode-X kernels against their plain versions on the card.  Returns
    the same per-kernel dicts as phase_kernels for K4x, K11, "K6 (X)" (both
    launches together), K12e, "K3 (5 slots)", "K3p (5 slots)" and K12d."""
    import numpy as np
    import torch

    from comprox_tpu_torch.benchmarks import phases, work
    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.models import ppm

    dev = "cuda"
    pf = make_params("crx", {"lanes": 512, "block_mb": 8}).block
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="X",
                        min_len=pf.min_len, window=pf.window,
                        rolz_ctx_bytes=pf.rolz_ctx_bytes)
    n = p.capacity
    data = corpus[:n]
    inp = torch.from_numpy(data.reshape(p.lanes, p.steps).copy()).to(dev)
    n_c = blk._finder_config(p, True)[0]
    prices = blk.x_prices()
    res = {}

    def tables0():
        return ppm.init_tables(True, p.o3_bits, dev)

    # K4x at this window, and with the extension cut short.
    ck = blk.sort_candidates(p, inp, n, content=True)
    cp, plain_ms = _timed_plain(blk.sort_candidates_plain, p, inp, n, True)
    err = max(max_err([(ck, cp)]), _short_ext_err(p, inp, n, True))
    ms = _kernel_ms("K4x", lambda: (p, inp, n, True), blk.sort_candidates)
    _record(res, "K4x", err, ms, plain_ms, *work.k4(p, inp, n, True, out=ck))
    k4x_small = dict(res["K4x"])

    # KSx, the scan finder's search.  Bytes: the block read, six grids
    # written, the rows of the three tables that changed.
    def xsearch0():
        return blk._init_xsearch(p, dev)

    xk, xp = xsearch0(), xsearch0()
    blk.reset_launch_counts()
    gk = blk.search_scan(p, inp, n, xk)
    if blk.LAUNCHES["KSx"] != 1:
        raise AssertionError("KSx did not launch")
    gp, plain_ms = _timed_plain(blk.search_scan_plain, p, inp, n, xp)
    err = max_err([(gk, gp)] + list(zip(xk, xp)))
    ms = _kernel_ms("KSx", lambda: (p, inp, n, xsearch0()), blk.search_scan)
    _record(res, "KSx", err, ms, plain_ms,
            work.nbytes(inp, gk) + sum(_touched_bytes(a, b) for a, b in zip(xk, xsearch0())),
            work.scan_ops("KSx", p))
    del xk, xp

    # K6, X entry, first launch (three distance-priced candidates).
    kw = dict(prices=prices, n_c=n_c)
    d1k = blk.parse_scan(p, n, ck, **kw)
    d1p, plain1 = _timed_plain(lambda: blk.parse_scan_plain(p, n, ck, **kw))
    err1 = max_err([(d1k, d1p)])
    ms1 = _kernel_ms("K6", lambda: (p, n, ck), lambda *a: blk.parse_scan(*a, **kw))

    # K11 on the first parse.
    rk = blk.rep_scan(p, inp, n, d1k)
    rp, plain_ms = _timed_plain(blk.rep_scan_plain, p, inp, n, d1k)
    err = max_err([(rk, rp)])
    ms = _kernel_ms("K11", lambda: (p, inp, n, d1k), blk.rep_scan)
    _record(res, "K11", err, ms, plain_ms, *work.k11(p, inp, n, d1k, out=rk))

    # K6, X entry, second launch (with the repeat pair, tried last).
    d2k = blk.parse_scan(p, n, ck, rep=rk, **kw)
    d2p, plain2 = _timed_plain(lambda: blk.parse_scan_plain(p, n, ck, rep=rk, **kw))
    err2 = max_err([(d2k, d2p)])
    ms2 = _kernel_ms("K6", lambda: (p, n, ck),
                     lambda *a: blk.parse_scan(*a, rep=rk, **kw))
    b1, o1 = work.k6(p, n, ck, out=d1k, **kw)
    b2, o2 = work.k6(p, n, ck, rep=rk, out=d2k, **kw)
    _record(res, "K6 (X)", max(err1, err2), ms1 + ms2, plain1 + plain2, b1 + b2, o1 + o2)
    print(f"K6, X entry at T={KERNEL_STEPS}: without the repeat pair {ms1:.3f} ms "
          f"(plain {plain1:.3f}), with it {ms2:.3f} ms (plain {plain2:.3f}); "
          f"max_abs_err {err1}, {err2}")

    # K12e on the second parse's decisions.
    dec = d2k[:2]
    tk, tp = tables0(), tables0()
    evk = blk.model_scan(p, inp, n, dec, tk)
    evp, plain_ms = _timed_plain(blk.model_scan_plain, p, inp, n, dec, tp)
    err = max_err([(evk, evp)] + _tables_pairs(tk, tp))
    ms = _kernel_ms("K12e", lambda: (p, inp, n, dec, tables0()), blk.model_scan)
    t0_ = tables0()
    tab_bytes = sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
    _record(res, "K12e", err, ms, plain_ms, work.nbytes(inp, dec, evk) + tab_bytes,
            work.scan_ops("K12e", p))

    # K3 at five slots.
    sk, ek, wk = blk.rans_scan(p, evk)
    (sp, ep, wp), plain_ms = _timed_plain(blk.rans_scan_plain, p, evk)
    err = max_err([(sk, sp), (ek, ep), (wk, wp)])
    ms = _kernel_ms("K3", lambda: (p, evk), blk.rans_scan)
    _record(res, "K3 (5 slots)", err, ms, plain_ms, *work.k3(p, evk, out=(sk, ek, wk)))

    # K3p on the five-slot mask.
    pk = blk.pack_emit(p, ek)
    pp, plain_ms = _timed_plain(blk.pack_emit_plain, ek)
    err = max_err([(pk, pp)])
    ms = _kernel_ms("K3p", lambda: (p, ek), blk.pack_emit)
    _record(res, "K3p (5 slots)", err, ms, plain_ms, *work.k3p(p, ek, out=pk))
    _k3b_cell(res, "K3b (5 slots)", pk, ek, wk)

    # K12d on the payload the kernels wrote.
    payload = blk._pack_payload(sk, pk, wk)
    n_words, st, stream = blk._unpack_payload(payload, p)
    st_t = torch.from_numpy(st.astype(np.int64)).to(dev)
    stream_t = torch.from_numpy(stream.astype(np.int32)).to(dev)
    tk, tp = tables0(), tables0()
    xk, uk, ok = blk.decode_scan(p, st_t, stream_t, n, tk)
    (xp, up, op), plain_ms = _timed_plain(
        blk.decode_scan_plain, p, st_t, stream_t, n, tp)
    if uk != up:
        raise AssertionError(f"K12d words used {uk} vs plain {up}")
    err = max_err([(xk, xp), (ok, op)] + _tables_pairs(tk, tp))
    blk._check_drain(xk.cpu().numpy(), uk, n_words)
    if not np.array_equal(ok.cpu().numpy().reshape(-1), data):
        raise AssertionError("K12d did not decode the block")
    ms = _kernel_ms("K12d", lambda: (p, st_t, stream_t, n, tables0()),
                    blk.decode_scan)
    tab_bytes = sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
    _record(res, "K12d", err, ms, plain_ms,
            4 * n_words + work.nbytes(st_t, ok) + tab_bytes, work.scan_ops("K12d", p))

    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']} (tolerance 0)  kernel "
              f"{r['ms']:.3f} ms ({r['ms'] * 1e3 / p.steps:.1f} us/step)  "
              f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  [mode X, S={p.lanes} T={p.steps} full tables]")

    # K4x at the main path's size, its sort stage beside torch.sort.
    nf = pf.capacity
    inpf = torch.from_numpy(corpus[:nf].reshape(pf.lanes, pf.steps).copy()).to(dev)
    propk = blk.sort_candidates(pf, inpf, nf, content=True)
    propp, plain_ms = _timed_plain(blk.sort_candidates_plain, pf, inpf, nf, True)
    err = max_err([(propk, propp)])
    del propp
    short_err = _short_ext_err(pf, inpf, nf, True)
    ms = _kernel_ms("K4x", lambda: (pf, inpf, nf, True), blk.sort_candidates)
    stages = phases.k4_stages(pf, inpf, nf, True)
    bytes_pad = blk.pad_block(pf, inpf)
    keys = blk.sort_keys_plain(pf, bytes_pad, nf, True)
    cfg = blk.finder_cfg(pf, nf, True)

    def sort_stage(with_passes=False):
        return blk.sort_positions(pf, bytes_pad, nf, tag="k4x", cfg=cfg,
                                  with_passes=with_passes)

    hs, ps, passes = sort_stage(True)
    hp, pp = torch.sort(keys, stable=True)
    err = max(err, max_err([(hs, hp), (ps, pp)]))
    del hs, ps, hp, pp
    sort_ms = _event_ms(sort_stage)
    lib_ms = _event_ms(lambda: torch.sort(keys, stable=True))
    _record(res, "K4x", max(err, short_err, k4x_small["max_abs_err"]), ms, plain_ms,
            *work.k4(pf, inpf, nf, True, out=propk), library_ms=lib_ms)
    r = res["K4x"]
    print(f"K4x at N={nf} (S=512 T={pf.steps}): max_abs_err {err}  kernel "
          f"{ms:.3f} ms  plain {plain_ms:.3f} ms  bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); its sort stage (keys + {passes} radix passes) "
          f"{sort_ms:.3f} ms, torch.sort(stable) of the same keys (int64) "
          f"{lib_ms:.3f} ms; at "
          f"T={KERNEL_STEPS}: kernel {k4x_small['ms']:.3f} ms, plain "
          f"{k4x_small['plain_ms']:.3f} ms; CPX_SORT_EXT=8 (the final stage's "
          f"scan arm): max_abs_err {short_err} at N={nf}, "
          f"{k4x_small['max_abs_err']} at T={KERNEL_STEPS} with the default's")
    print(phases.k4_stage_line(f"K4x at N={nf}", stages))
    for name, r in res.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(
                f"{name}: kernel != plain (max err {r['max_abs_err']})")
    return res


def phase_kernels_p(corpus):
    """The mode-P kernels against their plain versions on the card: K13c,
    K13e, K3 (three slots, counted under K3) and K13d chained at S=512,
    T=256 with the full-size LZP tables.  Returns the per-kernel dicts of
    K13c, K13e, K13d."""
    import numpy as np
    import torch

    from comprox_tpu_torch.benchmarks import work
    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.models import ppm

    dev = "cuda"
    pf = make_params("crp", {"lanes": 512, "block_mb": 8}).block
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="P",
                        min_len=pf.min_len, window=pf.window)
    n = p.capacity
    data = corpus[:n]
    inp = torch.from_numpy(data.reshape(p.lanes, p.steps).copy()).to(dev)
    res = {}

    def tables0():
        return ppm.init_tables(True, p.o3_bits, dev)

    def lzp0():
        return blk._init_lzp(p, dev)

    def touched(tk, zk):
        t0_, z0_ = tables0(), lzp0()
        return (sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
                + sum(_touched_bytes(zk[k], z0_[k]) for k in zk))

    # K13c, the whole block's candidates, before K13e reads them: the grid
    # and the LZP tables it leaves against the step walk of its plain
    # version.  Bounds: work.k13c.
    zk, zp = lzp0(), lzp0()
    blk.reset_launch_counts()
    grid = blk.lzp_candidates(p, inp, n, zk)
    if blk.LAUNCHES["K13c"] != 1:
        raise AssertionError("K13c did not launch")
    gridp, plain_ms = _timed_plain(blk.lzp_candidates_plain, p, inp, n, zp)
    err = max_err([(grid, gridp)] + _tables_pairs(zk, zp))
    ms = _kernel_ms("K13c", lambda: (p, inp, n, lzp0()), blk.lzp_candidates)
    _record(res, "K13c", err, ms, plain_ms, *work.k13c(p, inp, n, zk, out=grid))
    if not bool(((grid & 0xFFFF) > 0).any()):
        raise AssertionError("K13c found no match on corpus bytes")
    # ... and on an all-zero block (one key a table over every sort tile)
    # and a period-3 block, from empty tables and from the tables the
    # corpus left (the initial values take part in the max, as under -c)
    blocks = {"zeros": np.zeros(n, np.uint8),
              "period 3": np.tile(np.array([7, 61, 200], np.uint8), n // 3 + 1)[:n]}
    for name, block in blocks.items():
        b = torch.from_numpy(block.reshape(p.lanes, p.steps)).to(dev)
        for start in ("empty", "filled"):
            zk_ = lzp0() if start == "empty" else {k: v.clone() for k, v in zk.items()}
            zp_ = {k: v.clone() for k, v in zk_.items()}
            e_ = max_err([(blk.lzp_candidates(p, b, n, zk_),
                           blk.lzp_candidates_plain(p, b, n, zp_))] + _tables_pairs(zk_, zp_))
            print(f"K13c on a {name} block from {start} tables: max_abs_err {e_} "
                  f"(tolerance 0)")
            res["K13c"]["max_abs_err"] = max(res["K13c"]["max_abs_err"], e_)
    if corpus.size >= pf.capacity:  # the stages at the main path's width
        from comprox_tpu_torch.benchmarks import phases

        inpf = torch.from_numpy(corpus[:pf.capacity].reshape(pf.lanes, pf.steps).copy()).to(dev)
        print(phases.k4_stage_line("K13c", phases.kernel_stages("K13c", pf, inpf,
                                                                pf.capacity)))
        del inpf

    # K13e (K13c first, inside model_scan).  Bytes: the block and the grid
    # read, nine event grids written, the table rows this run changed.
    tk, tp, zk, zp = tables0(), tables0(), lzp0(), lzp0()
    blk.reset_launch_counts()
    evk = blk.model_scan(p, inp, n, None, tk, zk)
    if blk.LAUNCHES["K13e"] != 1 or blk.LAUNCHES["K13c"] != 1:
        raise AssertionError("K13c and K13e did not launch")
    evp, plain_ms = _timed_plain(blk.model_scan_plain, p, inp, n, None, tp, zp)
    err = max_err([(evk, evp)] + _tables_pairs(tk, tp) + _tables_pairs(zk, zp))
    ms = _kernel_ms("K13e", lambda: (p, inp, n, None, tables0(), lzp0()),
                    blk.model_scan)
    t0_ = tables0()
    _record(res, "K13e", err, ms, plain_ms,
            work.nbytes(inp, grid, evk) + sum(_touched_bytes(tk[k], t0_[k]) for k in tk),
            work.scan_ops("K13e", p))
    n_match = int(evk[:, 8].sum())
    if n_match == 0:
        raise AssertionError("K13e coded no match on corpus bytes")

    # K3 at three slots on K13e's events (the kernel mode R's phase holds).
    sk, ek, wk = blk.rans_scan(p, evk)
    sp, ep, wp = blk.rans_scan_plain(p, evk)
    if max_err([(sk, sp), (ek, ep), (wk, wp)]) != 0:
        raise AssertionError("K3 != plain on mode P's events")

    # K13d on the payload the kernels wrote.  Bytes: the words the stream
    # holds.
    payload = blk._pack_payload(sk, blk.pack_emit(p, ek), wk)
    n_words, st, stream = blk._unpack_payload(payload, p)
    st_t = torch.from_numpy(st.astype(np.int64)).to(dev)
    stream_t = torch.from_numpy(stream.astype(np.int32)).to(dev)
    tk, tp, zk, zp = tables0(), tables0(), lzp0(), lzp0()
    xk, uk, ok = blk.decode_scan(p, st_t, stream_t, n, tk, None, zk)
    (xp, up, op), plain_ms = _timed_plain(
        blk.decode_scan_plain, p, st_t, stream_t, n, tp, None, zp)
    if uk != up:
        raise AssertionError(f"K13d words used {uk} vs plain {up}")
    err = max_err([(xk, xp), (ok, op)] + _tables_pairs(tk, tp) + _tables_pairs(zk, zp))
    blk._check_drain(xk.cpu().numpy(), uk, n_words)
    if not np.array_equal(ok.cpu().numpy().reshape(-1), data):
        raise AssertionError("K13d did not decode the block")
    ms = _kernel_ms("K13d", lambda: (p, st_t, stream_t, n, tables0(), None, lzp0()),
                    blk.decode_scan)
    _record(res, "K13d", err, ms, plain_ms,
            4 * n_words + work.nbytes(st_t, ok) + touched(tk, zk),
            work.scan_ops("K13d", p))
    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']} (tolerance 0)  kernel "
              f"{r['ms']:.3f} ms ({r['ms'] * 1e3 / p.steps:.1f} us/step)  "
              f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  [mode P, S={p.lanes} T={p.steps} full tables, "
              f"{n_match} matches]")
        if r["max_abs_err"] != 0:
            raise AssertionError(
                f"{name}: kernel != plain (max err {r['max_abs_err']})")
    return res


BLOCKS_G = 4  # the block-axis cells' G
BLOCKS_SHORT = 1003  # the last block of the kernel cell: n = S * T - 1003


def _flat(x) -> list:
    """The tensors of a result (a tensor, or a tuple or dict of them), in
    order, for max_err."""
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return [x]


def _runs_ms(key, fn, launches, reps=3):
    """Mean CUDA-event ms of ``key``'s launches in one run of ``fn`` (which
    makes ``launches`` of them), over ``reps`` runs."""
    from comprox_tpu_torch.codec import block as blk

    blk.reset_launch_counts()
    for _ in range(reps):
        fn()
    ms = blk.kernel_ms()[key] / reps
    if blk.LAUNCHES[key] != reps * launches:
        raise AssertionError(f"{key}: {blk.LAUNCHES[key]} launches, not {reps * launches}")
    return ms


def phase_kernels_blocks(corpus):
    """Every batched arm (the block axis) against G one-block launches of
    the same kernel and against the plain loop (the plain version on each
    block in turn, on the card), at G = 4 blocks of S=512, T=256, full
    tables: four consecutive S*T spans of the corpus, the last n = S*T -
    1003 (its last lanes part-filled or empty).  Tolerance 0 on every grid,
    table, state and stream.  Returns {"<kernel> (blocks)": the kernel
    line's numbers}: ms of the batched launch, plain_ms of the plain loop,
    the bound at G = 4 (the sum of the four blocks' bounds,
    benchmarks/work.py); K3b's library_ms ``words[emit]`` over the G
    blocks; prints the G one-block launches' ms beside."""
    import numpy as np
    import torch

    from comprox_tpu_torch.benchmarks import work
    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec import block as blk

    dev, G = "cuda", BLOCKS_G
    res, beside = {}, {}

    def cell(name, key, run, parts, launches=1):
        """run(kind) -> the arm's results: kind "blocks" one batched launch,
        "one" a launch a block, "plain" the plain loop."""
        got, one = run("blocks"), run("one")
        plain, plain_ms = _timed_plain(run, "plain")
        err = max(max_err(zip(_flat(got), _flat(one))), max_err(zip(_flat(got), _flat(plain))))
        ms = _runs_ms(key, lambda: run("blocks"), launches)
        beside[name] = _runs_ms(key, lambda: run("one"), G * launches)
        nb, ops = (sum(x) for x in zip(*(parts(b, got) for b in range(G))))
        _record(res, f"{name} (blocks)", err, ms, plain_ms, nb, ops)
        return got

    def blocks_of(p):
        cap = p.capacity
        buf = corpus[: G * cap].reshape(G, p.lanes, p.steps).copy()
        ns = [cap] * (G - 1) + [cap - BLOCKS_SHORT]
        buf[-1].reshape(-1)[ns[-1]:] = 0
        return (torch.from_numpy(buf).to(dev), ns,
                torch.tensor(ns, dtype=torch.int32, device=dev))

    per_block = blk._per_block  # fn(b, n_b) on each block, stacked

    def touched(final, init):
        return sum(_touched_bytes(final[k], init[k]) for k in final)

    def decode_inputs(p, states, packed, words):
        """The G payloads' states [G, S] and streams [G, stream_pad]."""
        st, sm, nws = [], [], []
        for b in range(G):
            n_words, s_, stream = blk._unpack_payload(
                blk._pack_payload(states[b], packed[b], words[b]), p)
            st.append(s_.astype(np.int64))
            sm.append(stream[: p.stream_pad].astype(np.int32))
            nws.append(n_words)
        return (torch.from_numpy(np.stack(st)).to(dev),
                torch.from_numpy(np.stack(sm)).to(dev), nws)

    def tail(p, key, inp, ns, n, ev, tables0, match):
        """K3, K3p, K3b, then the decode scan ``key`` on the payloads."""
        sfx = "" if p.n_slots == 3 else " (5 slots)"

        def k3(kind):
            if kind == "blocks":
                return blk.rans_scan(p, ev)
            if kind == "one":
                return per_block(lambda b, _: blk.rans_scan(p, ev[b]), ns)
            return per_block(lambda b, _: blk.rans_scan_plain(p, ev[b]), ns)

        states, emit, words = cell("K3" + sfx, "K3", k3, lambda b, o: work.k3(
            p, ev[b], out=tuple(t[b] for t in o)))

        def k3p(kind):
            if kind == "blocks":
                return blk.pack_emit(p, emit)
            if kind == "one":
                return per_block(lambda b, _: blk.pack_emit(p, emit[b]), ns)
            return per_block(lambda b, _: blk.pack_emit_plain(emit[b]), ns)

        packed = cell("K3p" + sfx, "K3p", k3p, lambda b, o: work.k3p(p, emit[b], out=o[b]))

        def k3b(kind):
            if kind == "blocks":
                return _stream_of(*blk.compact_stream(packed, words))
            fn = blk.compact_stream if kind == "one" else blk.compact_stream_plain
            return _stream_of(*per_block(lambda b, _: fn(packed[b], words[b]), ns))

        cell("K3b" + sfx, "K3b", k3b, lambda b, o: work.k3b(
            packed[b], words[b], out=(o[0][b], o[1][b])))
        res[f"K3b{sfx} (blocks)"]["library_ms"] = _event_ms(lambda: words[emit])
        st, streams, nws = decode_inputs(p, states, packed, words)

        def dec(kind):
            def one_block(fn):
                def f(b, nb):
                    t, m = tables0(), match()
                    x, used, out = fn(p, st[b], streams[b], nb, t, *m)
                    return x, torch.tensor(int(used)), out, t, *[z for z in m if z is not None]
                return per_block(f, ns)
            if kind == "blocks":
                t, m = blk.init_tables_blocks(p, dev, G), match(G)
                x, used, out = blk.decode_scan(p, st, streams, n, t, *m)
                return (x, used.cpu(), out, t, *[z for z in m if z is not None])
            return one_block(blk.decode_scan if kind == "one" else blk.decode_scan_plain)

        def dec_parts(b, o):
            t0_ = tables0()
            nb = 4 * nws[b] + work.nbytes(st[b], o[2][b]) + touched(
                {k: v[b] for k, v in o[3].items()}, t0_)
            for z, z0 in zip(o[4:], [z for z in match() if z is not None]):
                nb += (touched({k: v[b] for k, v in z.items()}, z0) if isinstance(z, dict)
                       else _touched_bytes(z[b], z0))
            return nb, work.scan_ops(key, p)

        x, used, out = cell(key, key, dec, dec_parts)[:3]
        for b in range(G):
            blk._check_drain(x[b].cpu().numpy(), int(used[b]), nws[b])
        if not all(torch.equal(out[b].reshape(-1)[:nb], inp[b].reshape(-1)[:nb])
                   for b, nb in enumerate(ns)):
            raise AssertionError(f"{key} (blocks) did not decode the blocks")

    # mode R: K4 (a launch a block), K5, K6, K2, K3, K3p, K1
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="R", min_len=5,
                        window=250, rolz_ctx_bytes=4, rolz_dec=2)
    inp, ns, n = blocks_of(p)

    def tables0(G_=None):
        return blk.init_tables_blocks(p, dev, G_)

    props = blk.sort_candidates(p, inp, n)

    def k5(kind):
        if kind == "blocks":
            r = blk._init_rolz(p, dev, G)
            return blk.rank_scan(p, inp, n, props, r), r
        fn = blk.rank_scan if kind == "one" else blk.rank_scan_plain

        def f(b, nb):
            r = blk._init_rolz(p, dev)
            return fn(p, inp[b], nb, props[b], r), r
        return per_block(f, ns)

    ck = cell("K5", "K5", k5, lambda b, o: (
        work.nbytes(inp[b], props[b], o[0][b]) + _touched_bytes(o[1][b], blk._init_rolz(p, dev)),
        work.scan_ops("K5", p, o[0][b])))[0]

    def k6(kind):
        if kind == "blocks":
            return blk.parse_scan(p, n, ck)
        fn = blk.parse_scan if kind == "one" else blk.parse_scan_plain
        return per_block(lambda b, nb: fn(p, nb, ck[b]), ns)

    dk = cell("K6", "K6", k6, lambda b, o: work.k6(p, ns[b], ck[b], out=o[b]))

    def k2(kind):
        if kind == "blocks":
            t = tables0(G)
            return blk.model_scan(p, inp, n, dk, t), t
        fn = blk.model_scan if kind == "one" else blk.model_scan_plain

        def f(b, nb):
            t = tables0()
            return fn(p, inp[b], nb, dk[b], t), t
        return per_block(f, ns)

    evk = cell("K2", "K2", k2, lambda b, o: (
        work.nbytes(inp[b], dk[b], o[0][b]) + touched({k: v[b] for k, v in o[1].items()},
                                                      tables0()),
        work.scan_ops("K2", p)))[0]
    tail(p, "K1", inp, ns, n, evk, tables0,
         lambda G_=None: (blk._init_rolz(p, dev, G_),))

    # mode X: K4x (a launch a block), K6 twice, K11, K12e, K3 and K3p at
    # five slots, K12d
    pf = make_params("crx", {"lanes": 512, "block_mb": 8}).block
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="X", min_len=pf.min_len,
                        window=pf.window, rolz_ctx_bytes=pf.rolz_ctx_bytes)
    inp, ns, n = blocks_of(p)
    cx = blk.sort_candidates(p, inp, n, content=True)
    kw = dict(prices=blk.x_prices(), n_c=blk._finder_config(p, True)[0])

    def k6x(kind, rep=None):
        if kind == "blocks":
            return blk.parse_scan(p, n, cx, rep=rep, **kw)
        fn = blk.parse_scan if kind == "one" else blk.parse_scan_plain
        return per_block(lambda b, nb: fn(p, nb, cx[b], rep=None if rep is None else rep[b],
                                          **kw), ns)

    d1 = k6x("blocks")

    def k11(kind):
        if kind == "blocks":
            return blk.rep_scan(p, inp, n, d1)
        fn = blk.rep_scan if kind == "one" else blk.rep_scan_plain
        return per_block(lambda b, nb: fn(p, inp[b], nb, d1[b]), ns)

    rk = cell("K11", "K11", k11, lambda b, o: work.k11(p, inp[b], ns[b], d1[b], out=o[b]))

    def k6x_both(kind):
        return k6x(kind), k6x(kind, rk)

    d1, d2 = cell("K6 (X)", "K6", k6x_both, lambda b, o: tuple(
        x + y for x, y in zip(work.k6(p, ns[b], cx[b], out=o[0][b], **kw),
                              work.k6(p, ns[b], cx[b], rep=rk[b], out=o[1][b], **kw))),
        launches=2)
    dec = d2[:, :2].contiguous()

    def tables0(G_=None):
        return blk.init_tables_blocks(p, dev, G_)

    def k12e(kind):
        if kind == "blocks":
            t = tables0(G)
            return blk.model_scan(p, inp, n, dec, t), t
        fn = blk.model_scan if kind == "one" else blk.model_scan_plain

        def f(b, nb):
            t = tables0()
            return fn(p, inp[b], nb, dec[b], t), t
        return per_block(f, ns)

    evx = cell("K12e", "K12e", k12e, lambda b, o: (
        work.nbytes(inp[b], dec[b], o[0][b]) + touched({k: v[b] for k, v in o[1].items()},
                                                       tables0()),
        work.scan_ops("K12e", p)))[0]
    tail(p, "K12d", inp, ns, n, evx, tables0, lambda G_=None: ())

    # mode P: K13c (a launch a block, inside model_scan), K13e, K3, K3p, K13d
    pf = make_params("crp", {"lanes": 512, "block_mb": 8}).block
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="P", min_len=pf.min_len,
                        window=pf.window)
    inp, ns, n = blocks_of(p)

    def tables0(G_=None):
        return blk.init_tables_blocks(p, dev, G_)

    def k13e(kind):
        if kind == "blocks":
            t, z = tables0(G), blk._init_lzp(p, dev, G)
            return blk.model_scan(p, inp, n, None, t, z), t, z
        fn = blk.model_scan if kind == "one" else blk.model_scan_plain

        def f(b, nb):
            t, z = tables0(), blk._init_lzp(p, dev)
            return fn(p, inp[b], nb, None, t, z), t, z
        return per_block(f, ns)

    grids = blk.lzp_candidates(p, inp, n, blk._init_lzp(p, dev, G))
    evp = cell("K13e", "K13e", k13e, lambda b, o: (
        work.nbytes(inp[b], grids[b], o[0][b]) + touched({k: v[b] for k, v in o[1].items()},
                                                         tables0()),
        work.scan_ops("K13e", p)))[0]
    tail(p, "K13d", inp, ns, n, evp, tables0,
         lambda G_=None: (None, blk._init_lzp(p, dev, G_)))

    for name, r in res.items():
        arm = name[: -len(" (blocks)")]
        print(f"{name}: max_abs_err {r['max_abs_err']} (tolerance 0)  one batched "
              f"launch {r['ms']:.3f} ms, {G} one-block launches {beside[arm]:.3f} ms  "
              f"plain loop {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  [G={G} S=512 T={KERNEL_STEPS} full tables, "
              f"last n = S*T - {BLOCKS_SHORT}]")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name}: != one-block launches or plain (max err "
                                 f"{r['max_abs_err']})")
    return res


GROUP_GOLDENS = ("crz_g4_flex_8MiB_S512.cpx", "crx_g4_flex_8MiB_S512.cpx",
                 "crp_g4_8MiB_S512.cpx", "crf_g4_flex_8MiB_S512.cpx")


def phase_golden_groups():
    """The JAX package's ``-g4 -b2`` goldens (four blocks of T=4096 of the 8
    MiB corpus, one a codec) decoded on the card with ``-g4`` and with
    ``-g1``, both to the committed corpus, and the corpus encoded again
    with ``-g4`` and with ``-g1`` to JAX's SHA-256.  ``-g1`` runs the
    pipelined schedule: the calls to the block codec's ``start`` are
    counted, one a coded block."""
    import numpy as np

    from comprox_tpu_torch.cli.main import make_params, parse_args
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.codec import container as con
    from comprox_tpu_torch.codec.container import decode_stream, encode_stream

    meta = json.loads((GOLDEN / "torch_golden.json").read_text())
    for name in GROUP_GOLDENS:
        m, arc = meta[name], (GOLDEN / name).read_bytes()
        if sha256(arc) != m["archive_sha256"]:
            raise AssertionError(f"{name}: fixture does not match its digest")
        codec, _, _, _, opts = parse_args(m["argv"].split() + ["in", "out"])
        cp = make_params(codec, opts)
        f = "_fast" if cp.block.mode == "F" else ""
        blocks = -(-m["input_bytes"] // cp.block.capacity)
        times, starts = {}, {}
        for g in (opts["group"], 1):
            blk.reset_launch_counts()
            out = io.BytesIO()
            with _counted(con, f"decode_block{f}_start") as calls:
                t0 = time.perf_counter()
                decode_stream(io.BytesIO(arc), out, "cuda", group=g)
                times[f"decode -g{g}"] = time.perf_counter() - t0
            starts[f"decode -g{g}"] = calls[0]
            _check_launched(name, f"decode -g{g}", cp.block)
            if sha256(out.getvalue()) != m["input_sha256"]:
                raise AssertionError(f"{name}: -g{g} decode differs from the corpus")
        corpus = np.frombuffer(out.getvalue(), np.uint8)
        for g in (opts["group"], 1):
            buf = io.BytesIO()
            blk.reset_launch_counts()
            with _counted(con, f"encode_block{f}_start") as calls:
                t0 = time.perf_counter()
                encode_stream(corpus, buf, cp, "cuda", group=g)
                times[f"encode -g{g}"] = time.perf_counter() - t0
            starts[f"encode -g{g}"] = calls[0]
            _check_launched(name, f"encode -g{g}", cp.block)
            if sha256(buf.getvalue()) != m["archive_sha256"]:
                raise AssertionError(f"{name}: the port's -g{g} archive differs from JAX's")
        if starts["decode -g1"] != blocks or starts["encode -g1"] != blocks:
            raise AssertionError(f"{name}: -g1 did not start each of its {blocks} blocks "
                                 f"once through the pipelined path: {starts}")
        print(f"{name} ({m['argv']}): decoded with -g{opts['group']} and -g1 to the corpus, "
              f"encoded again with -g{opts['group']} and -g1: sha256 == JAX golden; "
              f"starts of the pipelined block codec {json.dumps(starts)}; " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in times.items()))


@contextlib.contextmanager
def _patched(module, **fns):
    old = {k: getattr(module, k) for k in fns}
    for k, v in fns.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


@contextlib.contextmanager
def _counted(module, name):
    """``module.name`` counting its calls into the yielded one-element list."""
    calls, fn = [0], getattr(module, name)

    def counted(*a, **k):
        calls[0] += 1
        return fn(*a, **k)

    with _patched(module, **{name: counted}):
        yield calls


def _rotated(x, by):
    import numpy as np

    return np.concatenate([x[by:], x[:by]])


def _group_corpus(text_elf):
    """32 MiB less a ragged tail, four distinct full-width blocks: the 8 MiB
    text corpus, the 8 MiB ELF corpus, each rotated by 4 MiB, the last cut
    to 5 MiB + 777 bytes."""
    import numpy as np

    half = text_elf.size // 2
    text, elf = text_elf[:half], text_elf[half:]
    return np.concatenate([text, elf, _rotated(text, 4 << 20),
                           _rotated(elf, 4 << 20)[: (5 << 20) + 777]])


def phase_full_width_groups(text_elf):
    """``<codec> e -b8 -l512 -g4`` against ``-g1`` on 32 MiB less a ragged
    tail, four distinct full-width blocks: the 8 MiB text corpus, the 8 MiB
    ELF corpus, each rotated by 4 MiB, the last cut to 5 MiB + 777 bytes;
    crz, crx, crp.  The archives must be byte-equal and ``d -g4`` must
    give the input.  The launch counts are set to 0 just before the ``-g4``
    encode and read just after its decode.  Returns ({kernel: launches} of
    the ``-g4`` runs, by codec; {codec: the archive's SHA-256})."""
    import numpy as np
    import torch

    from comprox_tpu_torch.cli import main as cli
    from comprox_tpu_torch.codec import block as blk

    corpus = _group_corpus(text_elf)
    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / "corpus_g.bin"
    corpus.tofile(src)
    n = corpus.size
    p = cli.make_params("crz", {"lanes": 512, "block_mb": 8}).block
    clusters = blk.k5_max_clusters(p)
    print(f"input: {n} B (8 MiB text, 8 MiB ELF, each rotated by 4 MiB, the last "
          f"cut to 5 MiB + 777 B): 4 blocks of S=512, T=16384; K5's clusters "
          f"(8 CTAs a block) the card holds at once: {clusters}")
    out, shas = {}, {}
    for codec, needed in (("crz", ("K4", "K5", "K6", "K2", "K3", "K3p", "K3b", "K1",
                                   "SORT")),
                          ("crx", ("K4x", "K6", "K11", "K12e", "K3", "K3p", "K3b", "K12d",
                                   "SORT")),
                          ("crp", ("K13c", "K13e", "K3", "K3p", "K3b", "K13d"))):
        arcs, walls, dev_ms, peak, ms, each = {}, {}, {}, {}, {}, {}
        for g in (4, 1):
            arc, dst = WORK / f"g{g}.{codec}", WORK / f"g{g}.out"
            blk.reset_launch_counts()
            for side, argv in (("encode", ["e", str(src), str(arc), "-b8", "-l512"]),
                               ("decode", ["d", str(arc), str(dst)])):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = sum(blk.kernel_ms().values())
                t0 = time.perf_counter()
                cli.run(codec, argv + ["-q", f"-g{g}"], device="cuda")
                walls[g, side] = time.perf_counter() - t0
                dev_ms[g, side] = sum(blk.kernel_ms().values()) - before
                peak[g, side] = torch.cuda.max_memory_allocated()
            if g == 4:
                launches = dict(blk.LAUNCHES)
            ms[g] = {k: v for k, v in blk.kernel_ms().items() if blk.LAUNCHES[k]}
            each[g] = {k: ", ".join(f"{a.elapsed_time(b):.3f}" for a, b in blk._EVENTS[k])
                       for k in ms[g]}
            arcs[g] = arc.read_bytes()
            if not np.array_equal(np.fromfile(dst, np.uint8), corpus):
                raise AssertionError(f"{codec} -g{g}: the round trip is not bit-exact")
        if arcs[4] != arcs[1]:
            raise AssertionError(f"{codec}: the -g4 archive differs from the -g1 archive")
        print(f"{codec} e -b8 -l512 -g4 == -g1: {len(arcs[4])} B "
              f"({len(arcs[4]) * 8 / n:.4f} bpb), sha256 {sha256(arcs[4])}; d -g4 and -g1 "
              "bit-exact")
        for (g, side), w in walls.items():
            print(f"{codec} -g{g} {side}: {n / w / 1e6:.3f} MB/s ({w:.3f} s wall), "
                  f"kernels {dev_ms[g, side]:.3f} ms, idle share "
                  f"{1 - dev_ms[g, side] / 1e3 / w:.3f}, max_memory_allocated "
                  f"{peak[g, side] / 2**30:.3f} GiB")
        for g in (4, 1):
            print(f"{codec} -g{g} kernel ms a launch: " + "; ".join(
                f"{k} {each[g][k]}" + (f" (sum {v:.3f})" if "," in each[g][k] else "")
                for k, v in ms[g].items()))
        print(f"{codec} -g4 launches: " + json.dumps({k: v for k, v in launches.items() if v}))
        for name in needed:
            if launches[name] < 1:
                raise AssertionError(f"{codec} -g4: {name} was not launched")
        out[codec], shas[codec] = launches, sha256(arcs[4])
    for f in WORK.glob("g[14].*"):
        f.unlink()
    src.unlink()
    return out, shas


PIPE_NEEDED = {  # codec: (encode's kernels, decode's)
    "crz": (("K4", "K5", "K6", "K2", "K3", "K3p", "K3b", "SORT"), ("K1",)),
    "crx": (("K4x", "K6", "K11", "K12e", "K3", "K3p", "K3b", "SORT"), ("K12d",)),
    "crp": (("K13c", "K13e", "K3", "K3p", "K3b"), ("K13d",)),
    "crf": (("K7", "K6", "K8", "K9", "SORT"), ("K10",)),
}
CHAIN_B2 = ("crz_chain_flex_8MiB_S512.cpx", "crz_chainm_flex_8MiB_S512.cpx")  # -c, -C


@contextlib.contextmanager
def _sync_mode(mode):
    import torch

    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _spans(log, fn, no_sync=False):
    """``fn`` logging, a call a block, the (start, end) CUDA events of the
    launches made inside the call (``block._launch``'s); with ``no_sync``
    the call runs under ``torch.cuda.set_sync_debug_mode("error")``: an
    operation that waits for the device raises."""
    from comprox_tpu_torch.codec import block as blk

    def wrapped(*a, **k):
        before = {name: len(evs) for name, evs in blk._EVENTS.items()}
        if no_sync:
            with _sync_mode("error"):
                out = fn(*a, **k)
        else:
            out = fn(*a, **k)
        log.append([ev for name, evs in blk._EVENTS.items() for ev in evs[before[name]:]])
        return out

    return wrapped


def _gaps(ref, spans):
    """Device ms from block i's last kernel's end event to block i+1's first
    kernel's start event, at each boundary (``ref`` recorded before all)."""
    at = [(min(ref.elapsed_time(a) for a, _ in sp), max(ref.elapsed_time(b) for _, b in sp))
          for sp in spans]
    return [nxt[0] - cur[1] for cur, nxt in zip(at, at[1:])]


def phase_pipelined(text_elf, g4_sha, corpora):
    """The container's schedules at full width: ``<codec> e -b8 -l512`` at
    ``-g1`` (crz, crx, crp, crf) on the -g4 phase's 29 MiB + 777 bytes, four
    distinct blocks, first through the pipelined path (one block in flight;
    every ``start`` run under ``set_sync_debug_mode("error")``, so that a
    read-back in it raises; mode F's one read, K8's token count, allowed),
    then through the sequential one (``encode_fn`` and ``decode_fn`` the
    one-block codec).  The two archives must be byte-equal and equal to the
    codec's ``-g4`` archive (crf: its own ``-g4`` encode here), and each
    decode must give the input.  For each codec and schedule: wall, kernel
    ms, idle share, peak card memory and the device gap at each block
    boundary (from the end event of block i's last kernel to the start event
    of block i+1's first); the launch counts are set to 0 just before each
    pipelined run and read just after.  For crz, every pipelined gap must be
    below the sequential gap at the same boundary.  Then crz ``-c -b2`` and
    ``-C -b2`` (the JAX goldens' corpus) encoded under ``CPX_CHAIN_SPEC=1``
    (the speculative schedule) and ``0``, both to the goldens' SHA-256, and
    ``encode_block_stats`` on one full-width crz block, whose
    ``stream_words`` must equal the word count of that block's payload."""
    import os

    import numpy as np
    import torch

    from comprox_tpu_torch.cli import main as cli
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.codec import container as con
    from comprox_tpu_torch.codec import fast

    corpus = _group_corpus(text_elf)
    n = corpus.size
    print(f"input: {n} B, 4 blocks of S=512, T=16384 (the -g4 phase's)")
    reads = [0]
    real_tokenize = fast.tokenize

    def tokenize(*a, **k):  # mode F's start reads K8's token count
        reads[0] += 1
        with _sync_mode(0):
            return real_tokenize(*a, **k)

    for codec in ("crz", "crx", "crp", "crf"):
        cp = cli.make_params(codec, {"lanes": 512, "block_mb": 8})
        f = "_fast" if codec == "crf" else ""
        res, arcs, outs = {}, {}, {}
        for sched in ("pipelined", "sequential"):
            for side in ("encode", "decode"):
                spans = []
                if sched == "pipelined":
                    name = f"{side}_block{f}_start"
                    ctx = _patched(con, **{name: _spans(spans, getattr(con, name), True)})
                    kw = {}
                else:
                    ctx = contextlib.nullcontext()
                    one = (con._block_encoder if side == "encode" else con._block_decoder)(
                        cp.block, "cuda")
                    kw = {f"{side}_fn": _spans(spans, one)}
                buf = io.BytesIO()
                reads[0] = 0
                blk.reset_launch_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ref = torch.cuda.Event(enable_timing=True)
                ref.record()
                with ctx, _patched(fast, tokenize=tokenize):
                    t0 = time.perf_counter()
                    if side == "encode":
                        con.encode_stream(corpus, buf, cp, "cuda", **kw)
                    else:
                        con.decode_stream(io.BytesIO(arcs[sched]), buf, "cuda", **kw)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                ms = sum(blk.kernel_ms().values())
                if sched == "pipelined":
                    for k in PIPE_NEEDED[codec][side == "decode"]:
                        if blk.LAUNCHES[k] < 1:
                            raise AssertionError(f"{codec} -g1 {side}: {k} was not launched")
                    want_reads = len(spans) if (codec, side) == ("crf", "encode") else 0
                    if reads[0] != want_reads:
                        raise AssertionError(f"{codec} {side}: {reads[0]} token-count reads, "
                                             f"{want_reads} expected")
                res[sched, side] = (wall, ms, torch.cuda.max_memory_allocated(),
                                    _gaps(ref, spans), len(spans))
                if side == "encode":
                    arcs[sched] = buf.getvalue()
                else:
                    outs[sched] = buf.getvalue()
        if arcs["pipelined"] != arcs["sequential"]:
            raise AssertionError(f"{codec}: the pipelined archive differs from the sequential")
        if codec not in g4_sha:
            buf = io.BytesIO()
            con.encode_stream(corpus, buf, cp, "cuda", group=4)
            g4_sha[codec] = sha256(buf.getvalue())
        if sha256(arcs["pipelined"]) != g4_sha[codec]:
            raise AssertionError(f"{codec}: the -g1 archive differs from the -g4 archive")
        for sched, out in outs.items():
            if out != corpus.tobytes():
                raise AssertionError(f"{codec} {sched} decode differs from the input")
        print(f"{codec} e -b8 -l512 -g1: pipelined == sequential == -g4 archive, "
              f"{len(arcs['pipelined'])} B, sha256 {g4_sha[codec]}; both decodes bit-exact")
        for (sched, side), (wall, ms, peak, gaps, blocks) in res.items():
            print(f"{codec} -g1 {side}, {sched}: {blocks} blocks, {n / wall / 1e6:.3f} MB/s "
                  f"({wall:.3f} s wall), kernels {ms:.3f} ms, idle share "
                  f"{1 - ms / 1e3 / wall:.3f}, max_memory_allocated {peak / 2**30:.3f} GiB, "
                  f"gaps at the block boundaries (ms) "
                  + ", ".join(f"{g:.3f}" for g in gaps))
        if codec == "crz":
            for side in ("encode", "decode"):
                pipe, seq = res["pipelined", side][3], res["sequential", side][3]
                if len(pipe) != len(seq) or not all(a < b for a, b in zip(pipe, seq)):
                    raise AssertionError(f"crz {side}: a pipelined gap is not below the "
                                         f"sequential one: {pipe} against {seq}")
            print("crz: every pipelined gap is below the sequential gap at its boundary")
    meta = json.loads((GOLDEN / "torch_golden.json").read_text())
    for name in CHAIN_B2:
        m = meta[name]
        codec, _, _, _, opts = cli.parse_args(m["argv"].split() + ["in", "out"])
        cp = cli.make_params(codec, opts)
        data = np.frombuffer(corpora[name].tobytes(), np.uint8)
        line = []
        for spec in ("1", "0"):
            old = os.environ.get("CPX_CHAIN_SPEC")
            os.environ["CPX_CHAIN_SPEC"] = spec
            try:
                buf = io.BytesIO()
                with _counted(con, "encode_block_chained_start") as calls:
                    t0 = time.perf_counter()
                    con.encode_stream(data, buf, cp, "cuda", chain=True)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                if old is None:
                    del os.environ["CPX_CHAIN_SPEC"]
                else:
                    os.environ["CPX_CHAIN_SPEC"] = old
            if sha256(buf.getvalue()) != m["archive_sha256"]:
                raise AssertionError(f"{name}: CPX_CHAIN_SPEC={spec} archive differs from JAX's")
            line.append(f"CPX_CHAIN_SPEC={spec} {wall:.3f} s, {calls[0]} starts")
        print(f"{name} ({m['argv']}): sha256 == JAX golden under both schedules; "
              + "; ".join(line))
    p = cli.make_params("crz", {"lanes": 512, "block_mb": 8}).block
    one = np.frombuffer(corpora[MAIN_ARCHIVE].tobytes(), np.uint8)[: p.capacity]
    t0 = time.perf_counter()
    stats = blk.encode_block_stats(one, p, "cuda")
    t_stats = time.perf_counter() - t0
    payload = blk.encode_block(one, p, "cuda")
    words = int(np.frombuffer(payload[:4], "<u4")[0])
    if stats["stream_words"] != words:
        raise AssertionError(f"encode_block_stats: stream_words {stats['stream_words']}, "
                             f"the payload's word count {words}")
    print(f"encode_block_stats, crz -b8 -l512, one {one.size} B block ({t_stats:.3f} s): "
          f"stream_words == the payload's {words}; " + json.dumps(stats))


def phase_probes():
    """The nine probes at their own geometries, each kernel against its
    plain version (tolerance 0).  Returns ({name: record of its last
    headline case}, {name: launches in this phase})."""
    from comprox_tpu_torch.benchmarks import probes

    probes.reset_launch_counts()
    recs = probes.run()
    launches = dict(probes.LAUNCHES)
    res = {}
    for r in recs:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['label']}: kernel != plain "
                                 f"(max err {r['max_abs_err']})")
        if r["probe"] in launches and r["headline"]:
            res[r["probe"]] = dict(
                max_abs_err=r["max_abs_err"], ms=r["us"] / 1e3,
                plain_ms=r["plain_us"] / 1e3, bound_ms=r["bound_us"] / 1e3,
                bound_by=r["bound_by"],
                library_ms=None if r["library_us"] is None else r["library_us"] / 1e3)
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was not launched by the probes")
    print("probe launches: " + json.dumps(launches))
    return res, launches


FULL_WIDTH_STATS: dict = {}  # archive: (encode s, decode s, encode kernel ms, decode's)


def phase_full_width(corpus, codec, archive, flags, needed, finder="sort", scans=(),
                     block_mb=8, f_finder="sort"):
    """One path through the CLI: <codec> e [flags] -b<block_mb> -l512 and
    <codec> d (mode X's candidates from ``finder``, mode F's decisions from
    ``f_finder``).  The launch counts are set to 0 just before and read just
    after.  For each step scan of ``scans`` (KS, KSx), its us a step beside
    its full-width bound, whose bytes an untimed encode after the timed one
    counts (``phases._bytes_of_scans``: the rows it changed, the block, the
    grids).  The walls and kernel ms go to ``FULL_WIDTH_STATS``."""
    import numpy as np

    from comprox_tpu_torch.cli import main as cli
    from comprox_tpu_torch.codec import block as blk

    want = json.loads((GOLDEN / "torch_golden.json").read_text())[archive]
    WORK.mkdir(parents=True, exist_ok=True)
    n = corpus.size
    steps = (block_mb << 20) // 512
    mib, blocks = n >> 20, -(-n // (512 * steps))
    src, arc, dst = WORK / "corpus.bin", WORK / f"corpus.{codec}", WORK / "out.bin"
    corpus.tofile(src)
    blk.reset_launch_counts()
    t0 = time.perf_counter()
    with finder_knob("CPX_X_FINDER", finder), f_finder_knob(f_finder):
        cli.run(codec, ["e", str(src), str(arc), *flags, f"-b{block_mb}", "-l512", "-q"],
                device="cuda")
    t_enc = time.perf_counter() - t0
    ms_enc = blk.kernel_ms()
    t0 = time.perf_counter()
    cli.run(codec, ["d", str(arc), str(dst), "-q"], device="cuda")
    t_dec = time.perf_counter() - t0
    ms_all = blk.kernel_ms()
    launches = dict(blk.LAUNCHES)
    got = arc.read_bytes()
    if sha256(got) != want["archive_sha256"]:
        raise AssertionError(
            f"{mib} MiB archive ({want['argv']}) differs from the JAX package's")
    if not np.array_equal(np.fromfile(dst, np.uint8), corpus):
        raise AssertionError(f"{mib} MiB round trip is not bit-exact")
    FULL_WIDTH_STATS[archive] = (t_enc, t_dec, sum(ms_enc.values()),
                                 sum(ms_all.values()) - sum(ms_enc.values()))
    print(f"{want['argv']}: {n} B, S=512, T={steps}, {blocks} block(s); archive "
          f"{len(got)} B == JAX golden (sha256 {sha256(got)}), "
          f"{len(got) * 8 / n:.4f} bpb; round trip bit-exact")
    print(f"encode {n / t_enc / 1e6:.3f} MB/s ({t_enc:.3f} s wall); "
          f"decode {n / t_dec / 1e6:.3f} MB/s ({t_dec:.3f} s wall)")
    each = {k: ", ".join(f"{a.elapsed_time(b):.3f}" for a, b in blk._EVENTS[k])
            for k in launches if launches[k] > 1}  # a launch's ms, in order
    print("kernel time (CUDA events): " + ", ".join(
        f"{k} {ms_all[k]:.3f} ms" + (f" ({launches[k]} launches: {each[k]})" if k in each else "")
        for k in ms_all if launches[k])
        + f"; encode kernels {sum(ms_enc.values()):.3f} ms, decode "
        f"{sum(ms_all.values()) - sum(ms_enc.values()):.3f} ms")
    print("launches: " + json.dumps(launches))
    for name in needed:
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on this path")
    if scans:
        from comprox_tpu_torch.benchmarks import phases, work

        moved, again = {}, WORK / f"again.{codec}"
        with finder_knob("CPX_X_FINDER", finder), f_finder_knob(f_finder), \
                phases._bytes_of_scans(moved):
            cli.run(codec, ["e", str(src), str(again), *flags, f"-b{block_mb}", "-l512",
                            "-q"], device="cuda")
        if again.read_bytes() != got:
            raise AssertionError("the encode for the bounds wrote other bytes")
        again.unlink()
        for k in scans:
            bound, by = work.bound(*moved[k])
            print(f"{k} at full width: {ms_enc[k]:.3f} ms over {launches[k]} launch(es), "
                  f"{ms_enc[k] * 1e3 / (steps * launches[k]):.2f} us/step; bound "
                  f"{bound:.4f} ms ({by})")
    for p in (src, arc, dst):
        p.unlink()
    return launches


def phase_chain_cell(corpus):
    """Chain mode v2 at full width: ``crz e -C -b8 -l512`` and ``crz d`` on
    the 16 MiB corpus (two chained blocks of S=512, T=16384) through
    phase_full_width (archive SHA-256 == the JAX golden); fails unless K4,
    KCR, K5ch, K6, K2, K3, K3p, K3b, K1ch and the sort were launched, or if the
    unchained K5 or K1 was.  Then the unchained ``-b8`` archive of the same
    input and its decode, for the bpb and the unchained arms' ms beside."""
    from comprox_tpu_torch.cli import main as cli
    from comprox_tpu_torch.codec import block as blk

    launches = phase_full_width(
        corpus, "crz", CHAIN_ARCHIVE, ["-C"],
        ("K4", "KCR", "K5ch", "K6", "K2", "K3", "K3p", "K3b", "K1ch", "SORT"))
    if launches["K5"] or launches["K1"]:
        raise AssertionError("the chained path launched the unchained K5 or K1")
    if launches["KCR"] != 4:
        raise AssertionError(f"KCR: {launches['KCR']} launches, not two a side")
    src, arc, dst = WORK / "corpus16.bin", WORK / "corpus16.crz", WORK / "out16.bin"
    corpus.tofile(src)
    ms = {}
    for side, argv in (("encode", ["e", str(src), str(arc), "-b8", "-l512", "-q"]),
                       ("decode", ["d", str(arc), str(dst), "-q"])):
        blk.reset_launch_counts()
        cli.run("crz", argv, device="cuda")
        ms.update({k: (v, blk.LAUNCHES[k]) for k, v in blk.kernel_ms().items()
                   if blk.LAUNCHES[k]})
    size = arc.stat().st_size
    if dst.read_bytes() != corpus.tobytes():
        raise AssertionError("the unchained 16 MiB round trip is not bit-exact")
    print(f"crz e -b8 -l512 (unchained) of the same {corpus.size} B: {size} B, "
          f"{size * 8 / corpus.size:.4f} bpb; kernel ms per launch: " + ", ".join(
              f"{k} {v / n:.3f} (x{n})" for k, (v, n) in ms.items()))
    for p in (src, arc, dst):
        p.unlink()
    return launches


def phase_fast_host_split(corpus):
    """Where the crf wall time goes on the host: the stages of ``crf e`` and
    ``crf d`` on the 8 MiB corpus, each called once more on its own and
    timed by the host clock (the block codec's calls end in a device
    synchronisation)."""
    import zlib

    import numpy as np
    import torch

    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.codec import dictionary as dic
    from comprox_tpu_torch.codec import fast
    from comprox_tpu_torch.utils import native

    p = make_params("crf", {"lanes": 512, "block_mb": 8}).block

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    wd, t_build = timed(dic.build_dictionary, corpus)
    sub, t_sub = timed(dic.dict_encode, corpus, wd)
    blk.reset_launch_counts()
    payload, t_enc = timed(fast.encode_block_fast, sub, p, "cuda")
    k_enc = sum(blk.kernel_ms().values())
    _, t_crc = timed(zlib.crc32, sub.tobytes())
    blk.reset_launch_counts()
    out, t_dec = timed(fast.decode_block_fast, payload, sub.size, p, "cuda")
    k_dec = sum(blk.kernel_ms().values())
    if not np.array_equal(out, sub):
        raise AssertionError("crf block round trip is not bit-exact")
    tok, t_tok = timed(fast.decode_tokens, payload, sub.size, p, "cuda")
    res, t_exec = timed(native.f2_execute, tok, p.min_len, sub.size)
    if res is None or not np.array_equal(res, sub):
        raise AssertionError("f2_execute did not rebuild the block")
    _, t_undict = timed(dic.dict_decode, sub, wd)
    print(f"crf host split, 8 MiB corpus -> {sub.size} B after the dictionary, "
          f"{tok.size} tokens, payload {len(payload)} B (host clock, ms): "
          f"dictionary build {t_build:.1f}, dictionary encode {t_sub:.1f}, "
          f"block encode {t_enc:.1f} (kernels {k_enc:.3f}), content CRC "
          f"{t_crc:.1f}; block decode {t_dec:.1f} (kernel {k_dec:.3f}; unpack, "
          f"K10 and the token plane to the host {t_tok:.1f}, f2_execute "
          f"{t_exec:.1f}, CRC as above), dictionary decode {t_undict:.1f}")


def phase_payload_pack(corpus_r, corpus_x):
    """The payload pack of an 8 MiB block, two ways on the same K3 outputs
    (crz: three slots; crx: five): host ms by the host clock between device
    synchronisations, the best of three.  The yardstick is the host
    compaction the port ran before K3b (the JAX package's _pack_payload):
    the words and the packed mask copied, then unpacked and indexed by
    numpy; the path is ``blk._pack_payload``: K3b, then the word count, the
    states and the stream copied.  The payloads must be equal."""
    import numpy as np
    import torch

    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec import block as blk

    def timed(fn, *args):
        out, ms = None, []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, min(ms)

    for codec, corpus in (("crz", corpus_r), ("crx", corpus_x)):
        p = make_params(codec, {"lanes": 512, "block_mb": 8}).block
        n = min(corpus.size, p.capacity)
        buf = np.zeros(p.capacity, np.uint8)
        buf[:n] = corpus[:n]
        inp = torch.from_numpy(buf.reshape(p.lanes, p.steps)).to("cuda")
        states, packed, words, _, _ = blk.encode_passes(p, inp, n)
        (packed_h, words_h), t_copy = timed(lambda: (packed.cpu(), words.cpu()))

        def host_compaction():
            emit = np.unpackbits(packed_h.numpy(), axis=-1, bitorder="little").astype(bool)
            stream = words_h.numpy()[emit]
            return (np.array([stream.size], np.uint32).tobytes()
                    + states.cpu().numpy().astype("<u4").tobytes()
                    + stream.astype("<u2").tobytes())

        host, t_host = timed(host_compaction)
        blk.reset_launch_counts()
        card, t_card = timed(blk._pack_payload, states, packed, words)
        k3b_ms = blk.kernel_ms()["K3b"] / blk.LAUNCHES["K3b"]
        if card != host:
            raise AssertionError(f"{codec}: K3b's payload differs from the host compaction's")
        shifts = torch.arange(8, dtype=torch.uint8, device="cuda")
        flags = ((packed.unsqueeze(-1) >> shifts) & 1).reshape(words.shape).bool()
        lib_ms = _event_ms(lambda: words[flags])
        print(f"payload pack, {codec} block of {n} B (S=512, T={p.steps}, {p.n_slots} slots; "
              f"words {words.numel() * 4} B, mask {packed.numel()} B, payload {len(card)} B): "
              f"host compaction {t_copy + t_host:.3f} ms (the copies {t_copy:.3f}, "
              f"unpack and index {t_host:.3f}); K3b and the copies {t_card:.3f} ms "
              f"(K3b {k3b_ms:.3f} ms on the card; words[emit], one masked_select on "
              f"the card, {lib_ms:.3f} ms)")


FSCAN_NEEDED = ("K4x", "SORT", "K6", "K11", "K8", "K9", "K10")
FXSCAN_NEEDED = ("KSx", "K6", "K11", "K8", "K9", "K10")


def phase_fscan(corpora, text_elf):
    """crf under ``CPX_F_FINDER=scan`` (mode X's finder and parse) at full
    width: ``crf e -b8 -l512`` and ``crf d`` on the 8 MiB corpus through
    phase_full_width, the archive's SHA-256 == the JAX golden; fails unless
    K4x, the sort, K6 (twice: mode X's prices, then the repeat pair), K11,
    K8, K9 and K10 were launched, or if K7 was.  The same at 1 MiB
    (``-b1``) under ``CPX_X_FINDER=scan`` as well: KSx launched, K4x and K7
    not.  Then a 16 MiB block (T=32768, mode F's largest) of the text and
    ELF corpus, ``-b16``, encoded and decoded bit-exact.  Prints the walls
    and kernel ms beside the sort route's (phase 20).  Returns the launches
    of the 8 MiB and the 1 MiB run."""
    import numpy as np

    from comprox_tpu_torch.cli import main as cli
    from comprox_tpu_torch.codec import block as blk

    xsort = phase_full_width(corpora[FSCAN_ARCHIVE], "crf", FSCAN_ARCHIVE, [],
                             FSCAN_NEEDED, f_finder="scan")
    if xsort["K7"] or xsort["K6"] != 2:
        raise AssertionError(f"crf under the scan route: K7 {xsort['K7']} launches, "
                             f"K6 {xsort['K6']} (K4x's route launches K6 twice, K7 never)")
    scan = phase_full_width(corpora[FXSCAN_ARCHIVE], "crf", FXSCAN_ARCHIVE, [],
                            FXSCAN_NEEDED, finder="scan", block_mb=1, f_finder="scan")
    if scan["K4x"] or scan["K7"] or scan["K6"] != 2:
        raise AssertionError(f"crf under the X scan finder: K4x {scan['K4x']}, K7 "
                             f"{scan['K7']}, K6 {scan['K6']} launches")
    for name in (FAST_ARCHIVE, FSCAN_ARCHIVE, FXSCAN_ARCHIVE):
        t_enc, t_dec, k_enc, k_dec = FULL_WIDTH_STATS[name]
        print(f"crf route {name}: encode {t_enc:.3f} s wall, kernels {k_enc:.3f} ms; "
              f"decode {t_dec:.3f} s wall, kernels {k_dec:.3f} ms")
    src, arc, dst = WORK / "corpus16f.bin", WORK / "corpus16f.crf", WORK / "out16f.bin"
    text_elf.tofile(src)
    blk.reset_launch_counts()
    t0 = time.perf_counter()
    with f_finder_knob("scan"):
        cli.run("crf", ["e", str(src), str(arc), "-b16", "-l512", "-q"], device="cuda")
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli.run("crf", ["d", str(arc), str(dst), "-q"], device="cuda")
    t_dec = time.perf_counter() - t0
    if not np.array_equal(np.fromfile(dst, np.uint8), text_elf):
        raise AssertionError("CPX_F_FINDER=scan crf -b16: the round trip is not bit-exact")
    for k in FSCAN_NEEDED:
        if blk.LAUNCHES[k] < 1:
            raise AssertionError(f"CPX_F_FINDER=scan crf -b16: {k} was not launched")
    size = arc.stat().st_size
    print(f"CPX_F_FINDER=scan crf e -b16 -l512: {text_elf.size} B, one block of S=512, "
          f"T=32768, {size} B ({size * 8 / text_elf.size:.4f} bpb), round trip bit-exact; "
          f"encode {t_enc:.3f} s, decode {t_dec:.3f} s wall, kernels "
          f"{sum(blk.kernel_ms().values()):.3f} ms")
    for p in (src, arc, dst):
        p.unlink()
    return xsort, scan


JOBS_ROWS = {  # the -j runs' launches -> the kernels line's rows
    "crz": {"K4": "K4", "SORT": "SORT", "K5": "K5 (blocks)", "K6": "K6 (blocks)",
            "K2": "K2 (blocks)", "K3": "K3 (blocks)", "K3p": "K3p (blocks)",
            "K3b": "K3b (blocks)", "K1": "K1 (blocks)"},
    "crx": {"K4x": "K4x", "SORT": "SORT", "K6": "K6 (X) (blocks)", "K11": "K11 (blocks)",
            "K12e": "K12e (blocks)", "K3": "K3 (5 slots) (blocks)",
            "K3p": "K3p (5 slots) (blocks)", "K3b": "K3b (5 slots) (blocks)",
            "K12d": "K12d (blocks)"},
    "crp": {"K13c": "K13c", "K13e": "K13e (blocks)", "K3": "K3 (blocks)",
            "K3p": "K3p (blocks)", "K3b": "K3b (blocks)", "K13d": "K13d (blocks)"},
    "crf": {"K7": "K7", "SORT": "SORT", "K8": "K8", "K9": "K9", "K10": "K10"},
}


def phase_jobs(text_elf, g4_sha):
    """``<codec> e -b8 -l512 -j`` and ``d -j`` (crz, crx, crp, crf) on the
    -g4 phase's input (four distinct full-width blocks), over two meshes:
    the mesh of every CUDA device (one card here: a mesh of one, a pool
    thread coding each block), and a mesh of two entries of ``cuda:0``
    (``jobs_mesh`` patched for the run: two pool threads launching at once
    on the one card, as a two-card run's threads would, each under
    ``torch.cuda.device``).  Mode F goes around the mesh.  Each archive
    must equal ``-g1``'s (the -g4 phase's SHA-256) and each decode be
    bit-exact; walls, kernel ms, idle share and peak of the one card.  The
    launch counts are set to 0 just before each encode and read after its
    decode; fails unless every kernel of the path was launched, unless each
    kernel recorded an event pair a launch, and (crz, crx, crp: a block a
    shard on either mesh) unless the two threads' counts equal the mesh of
    one's, so no count was lost between threads.  Returns {row of the
    kernels line: launches}."""
    import numpy as np
    import torch

    from comprox_tpu_torch.cli import main as cli
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.parallel import mesh as pmesh

    corpus = _group_corpus(text_elf)
    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / "corpus_j.bin"
    corpus.tofile(src)
    n = corpus.size
    meshes = {"-j": cli.jobs_mesh(-1, "cuda"),
              "two threads": pmesh.make_mesh(devices=["cuda:0"] * 2)}
    print(f"input: {n} B, 4 blocks of S=512, T=16384 (the -g4 phase's); -j: "
          f"{meshes['-j']}, {meshes['-j'].size} device(s); two threads: "
          f"{meshes['two threads']}: one card, so no multi-card figure")
    rows: dict = {}
    for codec in ("crz", "crx", "crp", "crf"):
        counts = {}
        for label, mesh in meshes.items():
            arc, dst = WORK / f"j.{codec}", WORK / "j.out"
            blk.reset_launch_counts()
            res = {}
            with _patched(cli, jobs_mesh=lambda jobs, device, mesh=mesh: mesh):
                for side, argv in (("encode", ["e", str(src), str(arc), "-b8", "-l512"]),
                                   ("decode", ["d", str(arc), str(dst)])):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    before = sum(blk.kernel_ms().values())
                    t0 = time.perf_counter()
                    cli.run(codec, argv + ["-q", "-j"], device="cuda")
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    res[side] = (wall, sum(blk.kernel_ms().values()) - before,
                                 torch.cuda.max_memory_allocated())
            launches = counts[label] = dict(blk.LAUNCHES)
            got = arc.read_bytes()
            if sha256(got) != g4_sha[codec]:
                raise AssertionError(f"{codec} -j ({label}): the archive differs from -g1's")
            if not np.array_equal(np.fromfile(dst, np.uint8), corpus):
                raise AssertionError(f"{codec} -j ({label}): the round trip is not bit-exact")
            enc_k, dec_k = PIPE_NEEDED[codec]
            for k in enc_k + dec_k:
                if launches[k] < 1:
                    raise AssertionError(f"{codec} -j ({label}): {k} was not launched")
            for k, v in launches.items():
                if len(blk._EVENTS[k]) != v:
                    raise AssertionError(f"{codec} -j ({label}): {k} launched {v} times, "
                                         f"{len(blk._EVENTS[k])} event pairs")
            print(f"{codec} e -b8 -l512 -j ({label}, mesh of {mesh.size}) == -g1: "
                  f"{len(got)} B, sha256 {sha256(got)}; d -j bit-exact")
            for side, (wall, ms, peak) in res.items():
                print(f"{codec} -j ({label}) {side} (one card): {n / wall / 1e6:.3f} MB/s "
                      f"({wall:.3f} s wall), kernels {ms:.3f} ms, idle share "
                      f"{1 - ms / 1e3 / wall:.3f}, max_memory_allocated "
                      f"{peak / 2**30:.3f} GiB")
            print(f"{codec} -j ({label}) launches: "
                  + json.dumps({k: v for k, v in launches.items() if v}))
            for k, row in JOBS_ROWS[codec].items():
                rows[row] = rows.get(row, 0) + launches[k]
            arc.unlink()
            dst.unlink()
        if codec != "crf" and counts["two threads"] != counts["-j"]:
            raise AssertionError(f"{codec}: the two threads' launch counts "
                                 f"{counts['two threads']} differ from one thread's "
                                 f"{counts['-j']}")
    src.unlink()
    return rows


DIST_TIMEOUT_S = 400  # a rank's limit (its start, the build's load, four blocks)


def phase_distributed(text_elf):
    """Two ranks of ``python -m comprox_tpu_torch.parallel.dryrun`` (world 2,
    gloo over 127.0.0.1, both on ``cuda:0``: the one card), each with its
    own timeout: mode R at S=512 and 8 MiB blocks on the -g4 phase's input
    (four blocks, two a rank).  Both ranks must return the file-ordered
    payloads, whose SHA-256 equals that of one process's
    ``encode_blocks_list`` (a block at a time), and decode the whole input
    bit-exact.  Prints each rank's walls and peak card memory; no speed-up
    figure (the two ranks share one card).  Either rank's failure or
    timeout fails the phase; both processes are ended."""
    import dataclasses
    import socket

    import torch

    from comprox_tpu_torch.cli import main as cli
    from comprox_tpu_torch.parallel import mesh as pmesh

    torch.cuda.empty_cache()  # the ranks share the card with this process
    corpus = _group_corpus(text_elf)
    p = cli.make_params("crz", {"lanes": 512, "block_mb": 8}).block
    WORK.mkdir(parents=True, exist_ok=True)
    src, out = WORK / "corpus_d.bin", WORK / "dist"
    corpus.tofile(src)
    out.mkdir(exist_ok=True)
    for old in out.glob("rank*.json"):
        old.unlink()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    logs = [open(out / f"rank{r}.log", "w") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "comprox_tpu_torch.parallel.dryrun", "--rank", str(r),
         "--world", "2", "--port", str(port), "--device", "cuda:0", "--input", str(src),
         "--out", str(out), "--params", json.dumps(dataclasses.asdict(p))],
        cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for r, proc in enumerate(procs):
            try:
                proc.wait(timeout=max(1.0, DIST_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} did not end within {DIST_TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    cap = p.capacity
    blocks = [corpus[b * cap : (b + 1) * cap] for b in range(-(-corpus.size // cap))]
    t1 = time.perf_counter()
    want = sha256(b"".join(pmesh.encode_blocks_list(blocks, p, group=1, device="cuda")))
    t_one = time.perf_counter() - t1
    for r, proc in enumerate(procs):
        path = out / f"rank{r}.json"
        if not path.exists():
            raise AssertionError(f"rank {r} (rc {proc.returncode}) wrote no record:\n"
                                 + (out / f"rank{r}.log").read_text()[-3000:])
        rec = json.loads(path.read_text())
        if proc.returncode != 0 or rec["error"] is not None or not rec.get("decoded_ok"):
            raise AssertionError(f"rank {r} failed (rc {proc.returncode}): {rec}")
        if rec["payloads_sha256"] != want:
            raise AssertionError(f"rank {r}: the payloads differ from one process's")
        print(f"rank {r} of 2 on {rec['device']}: {rec['blocks']} blocks, payloads sha256 "
              f"== one process's encode_blocks_list ({want}); decoded the whole input "
              f"bit-exact; encode {rec['encode_s']:.3f} s, decode {rec['decode_s']:.3f} s, "
              f"max_memory_allocated {rec['peak_bytes'] / 2**30:.3f} GiB")
    print(f"two ranks on one card, {corpus.size} B: {wall:.3f} s from start to end "
          f"(processes' start-up included); one process's encode_blocks_list "
          f"{t_one:.3f} s (no speed-up figure: the ranks share the card)")
    src.unlink()


def phase_dryrun():
    """``dryrun_multichip(torch.cuda.device_count())`` at the JAX package's
    geometry (S=512, 1 MiB blocks, 2^18 x 64 buckets, 2^22 o3 entries): a
    block a device, the tail uneven, round trip bit-exact, payloads equal
    to one device's a block at a time."""
    import torch

    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.parallel import dryrun

    blk.reset_launch_counts()
    t0 = time.perf_counter()
    payloads = dryrun.dryrun_multichip(torch.cuda.device_count())
    print(f"dryrun: {len(payloads)} payload(s), {time.perf_counter() - t0:.3f} s; "
          f"launches " + json.dumps({k: v for k, v in blk.LAUNCHES.items() if v}))


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    ph = Phases()
    smi = ph.run("device", phase_device)
    ph.run("build", phase_build)
    corpora = ph.run("golden", phase_golden)
    res = ph.run("kernels, mode R", phase_kernels, corpora[MAIN_ARCHIVE])
    res.update(ph.run("kernels, chain mode v2", phase_kernels_chain, corpora[MAIN_ARCHIVE]))
    res.update(ph.run("sort", phase_sort, corpora[MAIN_ARCHIVE]))
    res_f = ph.run("kernels, mode F", phase_kernels_fast, corpora[FAST_ARCHIVE])
    k6f = res_f.pop("K6F")
    res.update(res_f)
    res["K6"]["max_abs_err"] = max(res["K6"]["max_abs_err"], k6f["max_abs_err"])
    res.update(ph.run("kernels, mode X", phase_kernels_x, corpora[X_ARCHIVE]))
    for name, err in ph.run("kernels, K6 and K11 cases", phase_parse_cases).items():
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
    res.update(ph.run("kernels, mode P", phase_kernels_p, corpora[P_ARCHIVE]))
    res.update(ph.run("kernels, blocks", phase_kernels_blocks, corpora[MAIN_ARCHIVE]))
    res_probes, probe_launches = ph.run("probes", phase_probes)
    res.update(res_probes)
    crp = ph.run(
        "full width, crp", phase_full_width, corpora[P_ARCHIVE], "crp",
        P_ARCHIVE, [], ("K13c", "K13e", "K3", "K3p", "K3b", "K13d"))
    xscan = ph.run(
        "full width, crx under the scan finder", phase_full_width,
        corpora[XSCAN_ARCHIVE], "crx", XSCAN_ARCHIVE, [],
        ("KSx", "K6", "K11", "K12e", "K3", "K3p", "K3b", "K12d"), "scan", ("KSx",))
    if xscan["K4x"]:
        raise AssertionError("the scan finder's path launched K4x")
    crx = ph.run(
        "full width, crx", phase_full_width, corpora[X_ARCHIVE], "crx",
        X_ARCHIVE, [], ("K4x", "K11", "K6", "K12e", "K3", "K3p", "K3b", "K12d", "SORT"))
    launches = ph.run(
        "full width, crz flexible parse", phase_full_width, corpora[MAIN_ARCHIVE],
        "crz", MAIN_ARCHIVE, [], ("K4", "K5", "K6", "K2", "K3", "K3p", "K3b", "K1",
                                  "SORT"))
    chain = ph.run("full width, crz -C (chain mode v2)", phase_chain_cell,
                   corpora[CHAIN_ARCHIVE])
    for name in ("KCR", "K5ch", "K1ch"):
        launches[name] = chain[name]
    ph.run("step scans by phase", phase_scan_phases)
    greedy = ph.run(
        "full width, crz greedy parse", phase_full_width, corpora[GREEDY_ARCHIVE],
        "crz", GREEDY_ARCHIVE, ["-f0"], ("KS", "K2", "K3", "K3p", "K3b", "K1"), "sort",
        ("KS",))
    launches["KS"] = greedy["KS"]
    fast = ph.run(
        "full width, crf", phase_full_width, corpora[FAST_ARCHIVE], "crf",
        FAST_ARCHIVE, [], ("K7", "K6", "K8", "K9", "K10", "SORT"))
    for name in ("K7", "K8", "K9", "K10"):
        launches[name] = fast[name]
    for name in ("K4x", "K11", "K12e", "K12d"):
        launches[name] = crx[name]
    launches["KSx"] = xscan["KSx"]
    for name in ("K13c", "K13e", "K13d"):
        launches[name] = crp[name]
    launches["K6 (X)"], launches["K3 (5 slots)"] = crx["K6"], crx["K3"]
    launches["K3p (5 slots)"], launches["K3b (5 slots)"] = crx["K3p"], crx["K3b"]
    launches["SORT"] += crx["SORT"] + fast["SORT"]  # one in each of K4, K4x, K7
    launches.update(probe_launches)
    ph.run("golden, -b2", phase_golden_groups)
    grouped, g4_sha = ph.run("full width, -g4", phase_full_width_groups,
                             corpora[CHAIN_ARCHIVE])
    ph.run("pipelined container", phase_pipelined, corpora[CHAIN_ARCHIVE], g4_sha, corpora)
    for name, codec, key in (
            ("K5", "crz", "K5"), ("K6", "crz", "K6"), ("K2", "crz", "K2"),
            ("K1", "crz", "K1"), ("K11", "crx", "K11"), ("K6 (X)", "crx", "K6"),
            ("K12e", "crx", "K12e"), ("K3 (5 slots)", "crx", "K3"),
            ("K3p (5 slots)", "crx", "K3p"), ("K3b (5 slots)", "crx", "K3b"),
            ("K12d", "crx", "K12d"),
            ("K13e", "crp", "K13e"), ("K13d", "crp", "K13d")):
        launches[f"{name} (blocks)"] = grouped[codec][key]
    for name in ("K3", "K3p", "K3b"):  # three slots: crz and crp
        launches[f"{name} (blocks)"] = grouped["crz"][name] + grouped["crp"][name]
    ph.run("crf host split", phase_fast_host_split, corpora[FAST_ARCHIVE])
    ph.run("payload pack", phase_payload_pack, corpora[MAIN_ARCHIVE], corpora[X_ARCHIVE])
    fscan, fxscan = ph.run("full width, crf under mode X's finder", phase_fscan, corpora,
                           corpora[CHAIN_ARCHIVE])
    for name in ("K4x", "SORT", "K11", "K8", "K9", "K10"):
        launches[name] += fscan[name] + fxscan[name]
    launches["K6 (X)"] += fscan["K6"] + fxscan["K6"]
    launches["KSx"] += fxscan["KSx"]
    for row, n in ph.run("-j", phase_jobs, corpora[CHAIN_ARCHIVE], g4_sha).items():
        launches[row] += n
    ph.run("distributed, two ranks on one card", phase_distributed, corpora[CHAIN_ARCHIVE])
    ph.run("dryrun", phase_dryrun)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "comprox_tpu")]
    if bad:
        raise AssertionError(f"the port imported {bad}")
    import torch

    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": repl,
         "launches": launches[name], **res[name]}
        for name, source, repl in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
