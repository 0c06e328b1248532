// K1: the fused decode scan, with a kernel for mode R (K1) and one for the
// modes without a bucket table, X (K12d) and P (K13d).
//
// Replaces comprox_tpu/codec/block.py::_decode_scan (2218-2248) and
// _decode_body (1980-2215).  Mode R, per step and lane: contexts, o3 and
// bucket-row reads; the A event (o2 + SSE, slot -> symbol, rANS advance
// with a lane-ordered word read); B (o1 literal with exclusion, or the
// ROLZ index); C (match length); byte resolve (literal, o3 prediction, o1
// literal or a copy from the output); the shared model updates; the
// bucket insert of position pos-3.
//
// K1's chain arm (crz -C, cpx_k1c_launch; block.py:2200-2208, 2218-2248)
// is the same kernel with a window offset woff = N: `out` is the [2, S, T]
// window, region 0 the previous block's bytes (read, never written) and
// region 1 this block's, so a copy source indexes 2N bytes, the step's
// column goes to region 1, and each bucket insert lands at pos + N (its
// decimation stays on the block's own pos).  The unchained entry runs it
// with woff = 0.
//
// Bound on the H100: one CTA (above 1024 lanes one cluster of CTAs,
// ppm_r.cuh) runs T dependent steps of ~12 barrier-
// separated phases, and a coding lane reads ~1-2 KB of table rows per
// step, so latency (global round trips and barriers) bounds it, not
// bandwidth.  The lane-ordered word reads need one CTA-wide exclusive
// prefix per slot, done with warp ballots and a 32-entry shared scan
// instead of the JAX one-hot [S, S] product; the updates are winner-only
// stores or integer atomics (no float path, no per-lane serialisation);
// an event's symbol search runs only on the lanes that code it (JAX
// computes every lane and masks the result); bucket rows are read by
// whole warps (coalesced) into a shared-memory copy per lane, where the
// slot selections run.  The A and B events' o2 and o1 rows go through a
// per-warp cp.async ring (ppm_r.cuh: ring_start right after the contexts,
// so the bucket rows are read while they fly) and are coded two lanes at a
// time, a half-warp a lane; with the ring beside the bucket-row copies and
// SmemModel, K1 uses 232,128 of the H100's 232,448 B of shared memory a
// CTA at S=512, rolz_depth 64 (cpx_k1_launch moves the copies to device
// memory where they do not fit).  A match lane's index (B) and length (C)
// symbols are found by the warp's half-warp search of the shared row
// (ppm_r.cuh::warp_find_symbol), two lanes at a time.
//
// Mode X (k12d_kernel) keeps no match table: a match lane decodes its
// distance — B: the bucket, or symbol 24 for the lane's previous distance;
// C: the length, under the context bucket / 6; D and E: the mantissa bits
// (MantSplit in ppm_r.cuh), D through the adaptive [16, 16] table for
// buckets 5..16 — and copies from pos - dist of the output.  Five
// lane-ordered word reads a step, so five CTA-wide prefixes; the window
// start of each is clamped as lax.dynamic_slice clamps it, and in one CTA
// the words come from a copy of the step's span of the stream in shared
// memory (StreamWin).  The distance row, the len row and a mantissa row
// (under its sum, which upd_add keeps) are searched by the warp, two match
// lanes at a time (ppm_r.cuh::warp_find_symbol); the hit APM's bucket and
// weight come from a table in shared memory (ThrLut).  The mantissa
// table is read as the step found it, then every adaptive lane adds to it
// (integer atomics in shared memory) and a row over its cap is halved.  A
// lane that codes no match runs none of the B (distance), C, D, E symbol
// searches: whatever JAX computes there is masked before any table sees it.
//
// Mode P (the same kernel, MODE_P): before the A event each coding lane
// has its LZP candidate (block.py:2016-2021; ppm_r.cuh::lzp_slots,
// lzp_fetch, lzp_check) from the three shared tables, verified against the
// output bytes of earlier steps, because the hit APM is keyed by whether
// there is one; a
// match (A, then C under context 0: three word reads a step) copies from
// that source.  A step's scatter-max inserts (atomicMax) come with its
// byte, before the barrier that follows every read of the output; the
// next step's candidate is read after that barrier and verified after the
// add phase's, so the step opens with it in hand.  The step's column is
// written after that barrier too.
#include "ppm_r.cuh"

namespace {

struct StreamRead {
  const int* stream;
  int len, lanes;
  // Stream index of lane-order index excl of a window starting at start,
  // the start clamped as lax.dynamic_slice clamps it.
  __device__ __forceinline__ long long at(uint32_t start, int excl) const {
    long long s = start >= 0x80000000u ? 0 : (long long)start;
    s = max(0LL, min(s, (long long)(len - lanes)));
    return s + excl;
  }
  __device__ uint32_t word(uint32_t start, int excl) const {
    return (uint32_t)stream[at(start, excl)] & 0xFFFFu;
  }
};

// An instrumented build (-DCPX_K1_PROF, which the main path's build does
// not use; benchmarks/phases.py) stamps the SM clock at the end of each of
// K1's phases on thread 0 (CTA 0 of block 0), sums each phase over the steps and adds
// the sums to k1_prof at the end of the launch.
#define K1_PHASES 12
#ifdef CPX_K1_PROF
__device__ unsigned long long k1_prof[K1_PHASES];
#define K1_STAMP(k)                                   \
  if (gtid() == 0 && blockIdx.y == 0) {               \
    const long long now_ = prof_clock();              \
    prof_[k] += (unsigned long long)(now_ - stamp_);  \
    stamp_ = now_;                                    \
  }
#else
#define K1_STAMP(k)
#endif

template <int MAXT, bool CL>
__global__ void __launch_bounds__(MAXT) k1_kernel(Cfg c, const int* __restrict__ stream,
                          long long* __restrict__ states, Tables tb,
                          int* __restrict__ rolz, uint8_t* __restrict__ out,
                          long long* __restrict__ used, int* __restrict__ gpos,
                          bool pos_in_smem, int woff, const int* __restrict__ bn) {
  // block blockIdx.y of the launch: its n, stream row, states, tables,
  // bucket table, output (chained: the [2, S, T] window), word count and
  // bucket-row scratch
  blk_n(c, bn);
  stream = at_blk(stream, c.stream_len);
  states = at_blk(states, c.S);
  tb = tables_at(tb, c);
  rolz = at_blk(rolz, 2LL * c.rolz_depth << c.rolz_bits);
  out = at_blk(out, woff + (long long)c.S * c.T);
  used = at_blk(used, 1);
  gpos = at_blk(gpos, (long long)c.S * pos_pitch(c.rolz_depth));
  __shared__ SmemModel own;  // this CTA's keys and wtot; with CL, CTA 0's models serve all
  SmemModel& sm = *at_rank<CL>(&own, 0);
  // the warps' row rings, then (pos_in_smem) the lanes' bucket-row copies
  extern __shared__ __align__(16) int dyn[];
  int* const spos = dyn + ring_bytes(blockDim.x) / sizeof(int);
#ifdef CPX_K1_PROF
  __shared__ unsigned long long prof_[K1_PHASES];
  if (threadIdx.x < K1_PHASES) prof_[threadIdx.x] = 0;
  long long stamp_ = 0;
#endif
  const int i = gtid();
  const bool alive = i < c.S;
  const int d = c.rolz_depth;
  const long long cap_n = (long long)woff + (long long)c.S * c.T;  // the window's bytes
  const StreamRead sr{stream, c.stream_len, c.S};
  model_load(sm, tb);
  keyf_init(own.keyf);
  group_sync<CL>();
  uint32_t x = alive ? (uint32_t)states[i] : RANS_L;
  uint32_t base = 0;
  uint32_t ctx4 = 0, ctx4b = 0;
  int copy_rem = 0, copy_src = 0;
#ifdef CPX_K1_PROF
  stamp_ = prof_clock();
#endif
  // the lanes' copies of bucket rows: the A event's row until the byte is
  // resolved, then the insert row
  const int pitch = pos_pitch(d);
  int* const posbuf = pos_bufs(spos, gpos, pos_in_smem, pitch);
  int* const col = posbuf + (size_t)threadIdx.x * pitch;

  for (int t = 0; t < c.T; ++t) {
    o1_rescale(tb.o1, sm.o1sum, c.cap1);
    group_sync<CL>();
    K1_STAMP(0)

    // ---- A event: the coding lanes' o2 rows go in flight first, then
    // their bucket rows are read beside them
    Ctx cx = common_reads(c, tb, i, t, ctx4, copy_rem, alive);
    Upd u = {};
    uint32_t xt = 0;
    bool need = false;
    const bool coding = alive && cx.coding;
    RowRing ring = ring_start(dyn, tb.o2, O2_W, coding, cx.ctx2);
    K1_STAMP(1)
    int fill = warp_load_rows(
        rolz, d, coding,
        rolz_hash3(rolz_key(ctx4, c.rolz_ctx_bytes), c.rolz_bits), posbuf, pitch);
    K1_STAMP(2)
    const AEvent a = warp_a_event<true>(c, ring, coding, cx.ctx2, cx.pred,
                                        cx.conf, fill, sm.sse, sm.sse_h, x, 0,
                                        false);
    // the escaping lanes' o1 rows go in flight across the barriers to B
    ring = ring_start(dyn, tb.o1, O1_N, coding && a.sym == SYM_ESC, cx.p1);
    if (coding) {
      u.sse = a.sse;
      u.halvings = a.h;
      u.sym_a = a.sym;
      uint32_t ca, fa;
      norm_cf(a.c, max(a.f, 1), max(a.tot, 1), ca, fa);
      xt = dec_advance(x, ca, fa);
      need = xt < RANS_L;
    } else if (alive) {
      xt = dec_advance(x, 0, RANS_M);  // the identity event
      need = xt < RANS_L;
    }
    int inw = cta_excl_prefix_a(need, own.wtot[0]);
    group_sync<CL>();
    K1_STAMP(3)
    {
      int total;
      int ex = cta_excl_prefix_b<CL>(inw, own.wtot[0], total);
      if (need) x = (xt << 16) | sr.word(base, ex);
      else if (alive) x = xt;
      base += (uint32_t)total;
    }
    if (alive) {
      u.coding = cx.coding;
      u.is_lit = cx.coding && u.sym_a < 256;
      u.is_hit = cx.coding && u.sym_a == SYM_HIT;
      u.is_esc = cx.coding && u.sym_a == SYM_ESC;
      u.is_match = cx.coding && u.sym_a == SYM_MATCH;
      u.ctx2 = cx.ctx2; u.p1 = cx.p1; u.h3 = cx.h3; u.pred = cx.pred;
      u.conf = cx.conf; u.raw = cx.raw;
      u.idx_ctx = fill_bucket(fill);
      if (u.is_match) {
        const int ic = clampi(u.idx_ctx, 0, 3);
        mark_hot(&sm.hot_idx[ic], &sm.idx_sum[ic], c.idx_cap, &sm.due_idx);
      }
    }
    upd_keys(own, alive, u);
    group_sync<CL>();
    if (sm.due_idx) {  // the same on every thread: no barrier otherwise
      idx_rescale(c, sm);
      group_sync<CL>();
    }
    K1_STAMP(4)

    // ---- B event: o1 literal (escape lanes) or ROLZ index (match lanes,
    // by the warp's search of the index row)
    int sym1 = 0;
    need = false;
    const O1Event b = warp_o1_event<true>(ring, u.is_esc, cx.p1, a.ex, cx.pred,
                                          cx.pred2, cx.conf2 > 0, x, 0);
    const int ic = clampi(u.idx_ctx, 0, 3);
    const int tot_i = sm.idx_sum[ic];
    int ci_raw, fi_raw;
    const int sym_i = warp_find_symbol<IDX_W>(
        u.is_match, sm.idx, ic * IDX_W, (int)dec_target(x, max(tot_i, 1)), ci_raw, fi_raw);
    if (alive) {
      uint32_t cb = 0, fb = RANS_M;
      if (u.is_esc) {
        sym1 = b.sym;
        norm_cf(b.c, max(b.f, 1), max(b.tot, 1), cb, fb);
      } else if (u.is_match) {
        u.sym_idx = sym_i;
        u.len_ctx = rec_bucket(u.sym_idx);
        norm_cf(ci_raw, max(fi_raw, 1), max(tot_i, 1), cb, fb);
        const int lc = clampi(u.len_ctx, 0, 3);
        mark_hot(&sm.hot_len[lc], &sm.len_sum[lc], c.len_cap, &sm.due_len);
      }
      xt = dec_advance(x, cb, fb);
      need = xt < RANS_L;
    }
    inw = cta_excl_prefix_a(need, own.wtot[1]);
    group_sync<CL>();
    K1_STAMP(5)
    {
      int total;
      int ex = cta_excl_prefix_b<CL>(inw, own.wtot[1], total);
      if (need) x = (xt << 16) | sr.word(base, ex);
      else if (alive) x = xt;
      base += (uint32_t)total;
    }
    if (sm.due_len) {
      len_rescale(c, sm);
      group_sync<CL>();
    }
    K1_STAMP(6)

    // ---- C event: match length, by the warp's search of the len row
    need = false;
    const int lc = clampi(u.len_ctx, 0, 3);
    const int tot_l = sm.len_sum[lc];
    int cl_raw, fl_raw;
    const int sym_l = warp_find_symbol<LEN_W>(
        u.is_match, sm.len, lc * LEN_W, (int)dec_target(x, max(tot_l, 1)), cl_raw, fl_raw);
    if (alive) {
      uint32_t cc = 0, fc = RANS_M;
      if (u.is_match) norm_cf(cl_raw, max(fl_raw, 1), max(tot_l, 1), cc, fc);
      xt = dec_advance(x, cc, fc);
      need = xt < RANS_L;
    }
    inw = cta_excl_prefix_a(need, own.wtot[2]);
    group_sync<CL>();
    {
      int total;
      int ex = cta_excl_prefix_b<CL>(inw, own.wtot[2], total);
      if (need) x = (xt << 16) | sr.word(base, ex);
      else if (alive) x = xt;
      base += (uint32_t)total;
    }
    K1_STAMP(7)

    // ---- resolve the byte, prepare the updates and the bucket insert
    int byte = 0, src = 0, ins_key = -1;
    uint32_t ctx4n = ctx4, ctx4bn = ctx4b;
    const int s_match = warp_slot_of_rank(posbuf, pitch, d, u.is_match, u.sym_idx);
    if (alive) {
      if (u.is_match) src = (s_match >= 0 ? col[s_match] : 0) - 1;
      byte = u.is_lit ? u.sym_a : 0;
      if (u.is_hit) byte = cx.pred;
      if (u.is_esc) byte = sym1;
      if (u.is_match || cx.copying) {
        long long g = u.is_match ? src : copy_src;
        byte = out[max(0LL, min(g, cap_n - 1))];
      }
      byte = clampi(byte, 0, 255);
      u.byte = byte;
      u.f_byte = u.is_lit ? a.f : 0;
      u.sym_len = u.is_match ? sym_l : 0;
      if (cx.active) {
        ctx4n = (ctx4 << 8) | (uint32_t)byte;
        ctx4bn = (ctx4b << 8) | (ctx4 >> 24);
      }
      if (insert_here(c, cx.active, t, cx.pos))
        ins_key = (int)rolz_hash3(rolz_key(ctx4bn, c.rolz_ctx_bytes), c.rolz_bits);
    }
    key_post(own.key_ins, own.keyf, ins_key, SALT_INS);
    group_sync<CL>();
    K1_STAMP(8)
    int slot = bucket_slot<CL>(rolz, c, own.key_ins, own.keyf, SALT_INS, ins_key, posbuf, pitch);
    group_sync<CL>();
    K1_STAMP(9)

    // ---- stores, then additive updates
    upd_store<CL>(tb, own, u);
    if (alive) {
      if (slot >= 0)
        bucket_store(rolz, c, (uint32_t)ins_key, slot, cx.pos + woff, byteswap32(ctx4n));
      out[woff + (size_t)i * c.T + t] = (uint8_t)(cx.active ? byte : 0);
    }
    group_sync<CL>();
    K1_STAMP(10)
    key_clear(own.keyf, ins_key, SALT_INS);
    if (alive) {
      upd_add(c, tb, sm, own, u);
      copy_rem = u.is_match ? u.sym_len + (c.min_len - 1) : max(copy_rem - 1, 0);
      copy_src = u.is_match ? src + 1 : copy_src + 1;
      ctx4 = ctx4n;
      ctx4b = ctx4bn;
    }
    group_sync<CL>();
    upd_finish(sm);
    K1_STAMP(11)
  }
  group_sync<CL>();
#ifdef CPX_K1_PROF
  if (gtid() < K1_PHASES && blockIdx.y == 0) atomicAdd(&k1_prof[gtid()], prof_[gtid()]);
#endif
  model_store(sm, tb);
  if (alive) states[i] = (long long)x;
  if (i == 0) *used = (long long)base;
  if (CL) group_sync<CL>();  // CTA 0 stays until every CTA has read its models
}

// The step's stream words in shared memory (the tableless scan in one
// CTA).  A step's renorms read, in lane order, from windows that start at
// the clamped base of each and hold at most S words, so every word of a
// step lies in [clamp(base), clamp(base) + n_slots * S) for the base at
// the step's start.  That span, from its 16-byte aligned start and cut at
// the stream's last whole 16 bytes (n ints at most), is copied by cp.async
// into one of two shared buffers by step parity as soon as the base is
// known (the step before, after its last renorm) and waited for at the
// next step's first barrier; a renorm reads its word there, or from the
// stream where the word lies outside the copy, so the words and the clamp
// stay StreamRead's.  n = 0: no copy, every word from the stream.
struct StreamWin {
  int* buf;  // two buffers of n ints
  int n;

  // Copy the span of the step whose base is base into buffer b: [lo, hi)
  // of the stream.  Every thread of the CTA issues its 16-byte pieces and
  // commits one group.
  __device__ void stage(const StreamRead& sr, uint32_t base, int b, int& lo, int& hi) const {
    lo = (int)sr.at(base, 0) & ~3;
    hi = min(lo + n, sr.len & ~3);
    int* dst = buf + b * n;
    for (int q = threadIdx.x; lo + 4 * q < hi; q += blockDim.x) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 4 * q);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(sr.stream + lo + 4 * q)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ __forceinline__ uint32_t word(const StreamRead& sr, uint32_t start, int excl,
                                           int b, int lo, int hi) const {
    const int s = (int)sr.at(start, excl);
    return (uint32_t)(s >= lo && s < hi ? buf[b * n + s - lo] : sr.stream[s]) & 0xFFFFu;
  }
};

// Ints of one window buffer of the tableless scan of mode MODE: n_slots * S
// words from an aligned start, in 16-byte pieces.
static inline int stream_window_ints(const Cfg& c, int mode) {
  const int n_slots = mode == MODE_X ? 5 : 3;
  return (n_slots * c.S + 4 + 3) & ~3;
}

// Feed one word to every lane whose advanced state xt fell below the rANS
// lower bound, in lane order from the stream position base (one CTA-wide
// exclusive prefix; contains a barrier: call by every thread); the word
// from the step's window (buffer t & 1, span [wlo, whi)).
#define CPX_RENORM(slot)                                         \
  {                                                              \
    const int inw_ = cta_excl_prefix_a(need, own.wtot[slot]);    \
    group_sync<CL>();                                            \
    int total_;                                                  \
    const int ex_ = cta_excl_prefix_b<CL>(inw_, own.wtot[slot], total_); \
    if (need) x = (xt << 16) | win.word(sr, base, ex_, t & 1, wlo, whi); \
    else if (alive) x = xt;                                      \
    base += (uint32_t)total_;                                    \
  }

// An instrumented build (-DCPX_K12D_PROF, which the main path's build does
// not use; benchmarks/phases.py) stamps the SM clock at the end of each of
// the tableless scan's phases (ppm_r.cuh::PhaseClock) in both modes, into
// k12d_prof (mode X) or k13d_prof (mode P); mode P passes the stamp of
// the D and E events with nothing between.
#define K12D_PHASES 11
#ifdef CPX_K12D_PROF
__device__ unsigned long long k12d_prof[2 * K12D_PHASES];
__device__ unsigned long long k13d_prof[2 * K12D_PHASES];
#define K12D_STAMP(k) clk_.mark(k);
#else
#define K12D_STAMP(k)
#endif

// BLK: the batched arm (the block axis); the one-block arm rebases nothing
// (with the rebasing in it, K12d at S=512 held 128 registers with 8 B
// spilled and read 270.3 ms at full width against 264.2 without, on an
// H100 80GB HBM3 at 700 W: benchmarks/phases.py `times`, the two in turns).
template <int MAXT, int MODE, bool CL, bool BLK>
__global__ void __launch_bounds__(MAXT) k12d_kernel(Cfg c, const int* __restrict__ stream,
                            long long* __restrict__ states, Tables tb, Lzp lzp,
                            uint8_t* __restrict__ out,
                            long long* __restrict__ used, int win_n,
                            const int* __restrict__ bn) {
  constexpr bool XMODE = MODE == MODE_X;
  if (BLK) {
    // block blockIdx.y of the launch: its n, stream row, states, tables,
    // LZP tables, output and word count
    blk_n(c, bn);
    stream = at_blk(stream, c.stream_len);
    states = at_blk(states, c.S);
    tb = tables_at<MODE>(tb, c);
    lzp = lzp_at(lzp);
    out = at_blk(out, (long long)c.S * c.T);
    used = at_blk(used, 1);
  }
  __shared__ SmemModel own;  // this CTA's keys and wtot; with CL, CTA 0's models serve all
  SmemModel& sm = *at_rank<CL>(&own, 0);
  // the warps' row rings, the two stream windows (win_n ints each, maybe
  // 0), then the hit APM's bucket table
  extern __shared__ __align__(16) int dyn[];
  const int i = gtid();
  const bool alive = i < c.S;
  const long long cap_n = (long long)c.S * c.T;
  const StreamRead sr{stream, c.stream_len, c.S};
  const StreamWin win{dyn + ring_bytes(blockDim.x) / sizeof(int), CL ? 0 : win_n};
  int* const apm_lut = win.buf + 2 * win_n;
  model_load<MODE>(sm, tb);
  keyf_init(own.keyf);
  apm_lut_fill(apm_lut);
  uint32_t x = alive ? (uint32_t)states[i] : RANS_L;
  uint32_t base = 0;
  uint32_t ctx4 = 0, ctx4b = 0;
  int copy_rem = 0, copy_src = 0, prev_dist = 1;
  // the step's window span, and the next step's (staged the step before)
  int wlo = 0, whi = 0, nlo = 0, nhi = 0;
  if (win.n) win.stage(sr, base, 0, nlo, nhi);
  // a step's o3 entry, read in the step before's add phase (after the o3
  // winners' stores; nothing writes it later), and in mode P its LZP
  // candidate: the tables read once the step before's inserts are behind a
  // barrier (they come before its byte's barrier), the bytes they name
  // loaded after its add phase and compared once this step's rows are in
  // flight; so the step does not open on a round trip
  int raw_n = alive ? tb.o3[o3_slot(c, ctx4)] : 0;
  LzpSlots lz{-1, -1, -1};
  LzpPending lzp_next{lz, 0u, 0u, 0u};
  if (!XMODE && c.match && alive && i * c.T < c.n)
    lzp_next = lzp_fetch(c, out, 0, lzp_slots(lzp, ctx4, ctx4b));
  group_sync<CL>();
#ifdef CPX_K12D_PROF
  __shared__ unsigned long long prof_[2 * K12D_PHASES];
  PhaseClock<K12D_PHASES> clk_;
  clk_.start(prof_);
#endif

  for (int t = 0; t < c.T; ++t) {
    o1_rescale(tb.o1, sm.o1sum, c.cap1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // this step's window
    group_sync<CL>();
    wlo = nlo;
    whi = nhi;
    K12D_STAMP(0)

    // ---- A event
    Ctx cx = contexts(c, i, t, ctx4, copy_rem, alive, raw_n);
    Upd u = {};
    uint32_t xt = 0;
    bool need = false;
    const bool coding = alive && cx.coding;
    RowRing ring = ring_start(dyn, tb.o2, O2_W, coding, cx.ctx2);
    int lzp_src = 0;
    bool lzp_ok = false;
    if (!XMODE && coding && c.match)
      lzp_ok = lzp_check(c, t, ctx4, ctx4b, lzp_next, lzp_src);
    K12D_STAMP(1)
    const AEvent a = warp_a_event<true, MODE>(
        c, ring, coding, cx.ctx2, cx.pred, cx.conf,
        XMODE ? sse_x_ctx(cx.conf, cx.p1) : sse_p_ctx(cx.conf, lzp_ok, cx.p1),
        sm.sse, sm.sse_x, x, 0, false, nullptr, apm_lut);
    ring = ring_start(dyn, tb.o1, O1_N, coding && a.sym == SYM_ESC, cx.p1);
    if (coding) {
      u.sse = a.sse;
      u.halvings = a.h;
      u.sym_a = a.sym;
      uint32_t ca, fa;
      norm_cf(a.c, max(a.f, 1), max(a.tot, 1), ca, fa);
      xt = dec_advance(x, ca, fa);
      need = xt < RANS_L;
      // a match reads the distance row (X) or C's one len context (P): mark
      // it before the renorm's barrier, which then serves the rescale's flag
      if (a.sym == SYM_MATCH) {
        if (XMODE) mark_hot(&sm.hot_dst, &sm.dst_sum, c.dst_cap, &sm.due_idx);
        else mark_hot(&sm.hot_len[0], &sm.len_sum[0], c.len_cap, &sm.due_len);
      }
    } else if (alive) {
      xt = dec_advance(x, 0, RANS_M);  // the identity event
      need = xt < RANS_L;
    }
    K12D_STAMP(2)
    CPX_RENORM(0)
    if (alive) {
      u.coding = cx.coding;
      u.is_lit = cx.coding && u.sym_a < 256;
      u.is_hit = cx.coding && u.sym_a == SYM_HIT;
      u.is_esc = cx.coding && u.sym_a == SYM_ESC;
      u.is_match = cx.coding && u.sym_a == SYM_MATCH;
      u.ctx2 = cx.ctx2; u.p1 = cx.p1; u.h3 = cx.h3; u.pred = cx.pred;
      u.conf = cx.conf; u.raw = cx.raw;
    }
    upd_keys(own, alive, u);
    if (XMODE && sm.due_idx) {  // the same on every thread: no barrier otherwise
      dst_rescale(c, sm);
      group_sync<CL>();
    }
    K12D_STAMP(3)

    // ---- B event: o1 literal (escape lanes); mode X: or the distance
    // bucket (match lanes), by the warp's search of the distance row
    int sym1 = 0;
    need = false;
    const O1Event b = warp_o1_event<true>(ring, u.is_esc, cx.p1, a.ex, cx.pred,
                                          cx.pred2, cx.conf2 > 0, x, 0);
    int cd_raw = 0, fd_raw = 0, sym_b = 0;
    if (XMODE)
      sym_b = warp_find_symbol<DST_W>(u.is_match, sm.dst, 0,
                                      (int)dec_target(x, max(sm.dst_sum, 1)), cd_raw, fd_raw);
    if (alive) {
      uint32_t cb = 0, fb = RANS_M;
      if (u.is_esc) {
        sym1 = b.sym;
        norm_cf(b.c, max(b.f, 1), max(b.tot, 1), cb, fb);
      } else if (XMODE && u.is_match) {
        u.sym_dst = sym_b;
        norm_cf(cd_raw, max(fd_raw, 1), max(sm.dst_sum, 1), cb, fb);
        const int k_pre = clampi(
            u.sym_dst == SYM_DST_REPEAT ? dist_bucket(prev_dist) : u.sym_dst, 0, 24);
        u.len_ctx = min(k_pre / 6, 3);
        mark_hot(&sm.hot_len[u.len_ctx], &sm.len_sum[u.len_ctx], c.len_cap, &sm.due_len);
      }
      xt = dec_advance(x, cb, fb);
      need = xt < RANS_L;
    }
    CPX_RENORM(1)
    K12D_STAMP(4)
    if (sm.due_len) {
      len_rescale(c, sm);
      group_sync<CL>();
    }
    K12D_STAMP(5)

    // ---- C event: match length, by the warp's search of the len row
    need = false;
    const int lc = clampi(u.len_ctx, 0, 3);
    const int tot_l = sm.len_sum[lc];
    int cl_raw, fl_raw;
    const int sym_l = warp_find_symbol<LEN_W>(
        u.is_match, sm.len, lc * LEN_W, (int)dec_target(x, max(tot_l, 1)), cl_raw, fl_raw);
    if (alive) {
      uint32_t cc = 0, fc = RANS_M;
      if (u.is_match) norm_cf(cl_raw, max(fl_raw, 1), max(tot_l, 1), cc, fc);
      xt = dec_advance(x, cc, fc);
      need = xt < RANS_L;
    }
    CPX_RENORM(2)
    K12D_STAMP(6)

    // ---- D event: the mantissa's top bits (adaptive, by the warp's search
    // of the mantissa row under its kept sum, or uniform)
    const bool repeat = XMODE && u.is_match && u.sym_dst == SYM_DST_REPEAT;
    const int k_dist = clampi(repeat ? 0 : u.sym_dst, 0, 24);
    const bool has_extra = XMODE && u.is_match && !repeat;
    const MantSplit ms = mant_split(k_dist, has_extra);
    int sym_m = 0, e_hi = 0, e_lo = 0;
    if (XMODE) {
      need = false;
      const int mrow = clampi(k_dist - 5, 0, MANT_N - 1);
      const int tot_m = sm.mant_sum[mrow];
      int cm_raw, fm_raw;
      const int sym_d = warp_find_symbol<MANT_N>(
          ms.adaptive, sm.mant, mrow * MANT_N, (int)dec_target(x, max(tot_m, 1)), cm_raw, fm_raw);
      if (alive) {
        uint32_t cd = 0, fd = RANS_M;
        if (ms.adaptive) {
          sym_m = sym_d;
          norm_cf(cm_raw, max(fm_raw, 1), max(tot_m, 1), cd, fd);
        } else if (has_extra && ms.b_hi > 0) {
          fd = 1u << (15 - ms.b_hi);
          e_hi = (int)((x & (RANS_M - 1)) / fd);
          cd = (uint32_t)e_hi * fd;
        }
        xt = dec_advance(x, cd, fd);
        need = xt < RANS_L;
      }
      CPX_RENORM(3)

      // ---- E event: the mantissa's low bits (uniform)
      need = false;
      if (alive) {
        uint32_t ce = 0, fe = RANS_M;
        if (has_extra && ms.b_e > 0) {
          fe = 1u << (15 - ms.b_e);
          e_lo = (int)((x & (RANS_M - 1)) / fe);
          ce = (uint32_t)e_lo * fe;
        }
        xt = dec_advance(x, ce, fe);
        need = xt < RANS_L;
      }
      CPX_RENORM(4)
    }
    // the step's last word is read: the next step's window goes in flight
    if (win.n && t + 1 < c.T) win.stage(sr, base, (t + 1) & 1, nlo, nhi);
    K12D_STAMP(7)

    // ---- the distance (mode P: the candidate); resolve the byte; prepare
    // the updates
    int byte = 0, src = 0, dist = 1, copy_rem_n = copy_rem;
    uint32_t ctx4n = ctx4, ctx4bn = ctx4b;
    if (alive) {
      if (!XMODE) {
        if (u.is_match) src = lzp_src;
      } else if (u.is_match) {
        const int mant = ms.adaptive ? (sym_m << max(k_dist - 4, 0)) + e_lo
                                     : (e_hi << ms.b_lo) + e_lo;
        dist = repeat ? prev_dist : (1 << k_dist) + mant;
        src = cx.pos - dist;
        u.adaptive = ms.adaptive;
        u.mant_row = clampi(k_dist - 5, 0, 11);
        u.mant_sym = sym_m;
      }
      byte = u.is_lit ? u.sym_a : 0;
      if (u.is_hit) byte = cx.pred;
      if (u.is_esc) byte = sym1;
      if (u.is_match || cx.copying) {
        long long g = u.is_match ? src : copy_src;
        byte = out[max(0LL, min(g, cap_n - 1))];
      }
      byte = clampi(byte, 0, 255);
      u.byte = byte;
      u.f_byte = u.is_lit ? a.f : 0;
      u.sym_len = u.is_match ? sym_l : 0;
      if (cx.active) {
        ctx4n = (ctx4 << 8) | (uint32_t)byte;
        ctx4bn = (ctx4b << 8) | (ctx4 >> 24);
      }
      copy_rem_n = u.is_match ? u.sym_len + (c.min_len - 1) : max(copy_rem - 1, 0);
      // mode P: this step's inserts (no LZP table is read in the rest of the
      // step: the next step's candidate is read after the barrier below)
      if (!XMODE && c.match) lzp_insert(c, lzp, cx.active, t, cx.pos, ctx4n, ctx4bn);
    }
    group_sync<CL>();  // every copy has read the output before this step's write
    // the next step's LZP slots, after every insert of this step
    if (!XMODE && c.match && t + 1 < c.T && alive && cx.pos + 1 < c.n && copy_rem_n == 0)
      lz = lzp_slots(lzp, ctx4n, ctx4bn);
    K12D_STAMP(8)

    // ---- stores, then additive updates
    upd_store<CL>(tb, own, u);
    if (alive) {
      out[(size_t)i * c.T + t] = (uint8_t)(cx.active ? byte : 0);
    }
    group_sync<CL>();
    K12D_STAMP(9)
    if (alive) {
      upd_add<MODE>(c, tb, sm, own, u);
      copy_rem = copy_rem_n;
      copy_src = u.is_match ? src + 1 : copy_src + 1;
      if (u.is_match) prev_dist = dist;
      ctx4 = ctx4n;
      ctx4b = ctx4bn;
    }
    group_sync<CL>();
    // the next step's o3 entry; mode P: the bytes its candidate is checked
    // against (of this step and before: written before the stores'
    // barrier), compared when the step has started its rows
    if (t + 1 < c.T) {
      raw_n = alive ? tb.o3[o3_slot(c, ctx4)] : 0;
      if (!XMODE && c.match && alive && cx.pos + 1 < c.n && copy_rem == 0)
        lzp_next = lzp_fetch(c, out, t + 1, lz);
    }
    upd_finish<MODE>(sm, c.mant_cap);
    K12D_STAMP(10)
  }
#ifdef CPX_K12D_PROF
  clk_.flush(XMODE ? k12d_prof : k13d_prof);
#endif
  group_sync<CL>();
  model_store<MODE>(sm, tb);
  if (alive) states[i] = (long long)x;
  if (i == 0) *used = (long long)base;
  if (CL) group_sync<CL>();  // CTA 0 stays until every CTA has read its models
}

}  // namespace

// G blocks (the block axis): stream [G, stream_len], states [G, S], each
// table [G, ...], out [G, S, T], used [G], bn [G] (null: one block).
template <int MODE>
static int tableless_launch(const int* cfg, int G, const int* bn, const void* stream,
                            void* states, const Tables& tb, const Lzp& lzp, void* out,
                            void* used, void* cuda_stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  ScanGrid g = scan_grid(c.S);
  g.blocks = G;
  if (bn == nullptr && G != 1) return (int)cudaErrorInvalidValue;
  const bool one = bn == nullptr;  // the one-block arm
  auto kernel = g.ctas > 1 ? (one ? k12d_kernel<CPX_MAX_LANES, MODE, true, false>
                                  : k12d_kernel<CPX_MAX_LANES, MODE, true, true>)
              : g.threads <= 512 ? (one ? k12d_kernel<512, MODE, false, false>
                                        : k12d_kernel<512, MODE, false, true>)
                                 : (one ? k12d_kernel<CPX_MAX_LANES, MODE, false, false>
                                        : k12d_kernel<CPX_MAX_LANES, MODE, false, true>);
  // the rings, the two stream windows where one CTA runs the block, the
  // stream is 16-byte aligned and they fit beside the rings, the APM table
  // and the static SmemModel; then the APM table
  const size_t ring = ring_bytes(g.threads), lut = APM_LUT_N * sizeof(int);
  // (each block's stream row 16-byte aligned too)
  const bool aligned = !((uintptr_t)stream & 15) && (G == 1 || !(c.stream_len & 3));
  int win_n = g.ctas > 1 || !aligned ? 0 : stream_window_ints(c, MODE);
  if (ring + 2 * sizeof(int) * win_n + lut + sizeof(SmemModel) + 256 > CPX_SMEM_MAX) win_n = 0;
  return launch_scan(kernel, g, ring + 2 * sizeof(int) * win_n + lut, cuda_stream, c,
                     (const int*)stream, (long long*)states, tb, lzp, (uint8_t*)out,
                     (long long*)used, win_n, bn);
}

// Mode X: no bucket table; three more model tables.
extern "C" int cpx_k12d_launch(const int* cfg, int G, const void* bn,
                               const void* stream, void* states,
                               void* o2, void* o1, void* o3, void* len, void* idx,
                               void* sse, void* sse_h, void* dst, void* mant,
                               void* sse_x, void* out, void* used,
                               void* cuda_stream) {
  Tables tb{(int*)o2, (int*)o1, (int*)o3, (int*)len, (int*)idx, (int*)sse,
            (int*)sse_h, (int*)dst, (int*)mant, (int*)sse_x};
  return tableless_launch<MODE_X>(cfg, G, (const int*)bn, stream, states, tb,
                                  Lzp{nullptr, nullptr, nullptr}, out, used,
                                  cuda_stream);
}

// Mode P: the three LZP tables (null with the match layer off); sse_p is
// the hit APM.
extern "C" int cpx_k13d_launch(const int* cfg, int G, const void* bn,
                               const void* stream, void* states,
                               void* o2, void* o1, void* o3, void* len, void* idx,
                               void* sse_p, void* lzp2, void* lzp4, void* lzp8,
                               void* out, void* used, void* cuda_stream) {
  Tables tb{(int*)o2, (int*)o1, (int*)o3, (int*)len, (int*)idx, nullptr,
            nullptr, nullptr, nullptr, (int*)sse_p};
  return tableless_launch<MODE_P>(cfg, G, (const int*)bn, stream, states, tb,
                                  Lzp{(int*)lzp2, (int*)lzp4, (int*)lzp8}, out,
                                  used, cuda_stream);
}

// G blocks (the block axis; the chain arm takes one): as the tableless
// scan, and rolz [G, 2^bits, D, 2], gpos [G, S, D + 1].
static int k1_launch(const int* cfg, int G, const int* bn, const void* stream, void* states,
                     void* o2, void* o1, void* o3, void* len, void* idx, void* sse,
                     void* sse_h, void* rolz, void* out, void* used, void* gpos,
                     void* cuda_stream, int chained) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  Tables tb{(int*)o2, (int*)o1, (int*)o3, (int*)len, (int*)idx, (int*)sse,
            (int*)sse_h, nullptr, nullptr, nullptr};
  ScanGrid g = scan_grid(c.S);
  g.blocks = G;
  // the rings, then the lanes' bucket-row copies where they fit beside the
  // rings and the static SmemModel (else in gpos)
  const size_t ring = ring_bytes(g.threads);
  size_t pos = pos_smem_bytes(c);
  if (ring + pos + sizeof(SmemModel) + 256 > CPX_SMEM_MAX) pos = 0;
  auto kernel = g.ctas > 1 ? k1_kernel<CPX_MAX_LANES, true>
              : g.threads <= 512 ? k1_kernel<512, false> : k1_kernel<CPX_MAX_LANES, false>;
  if (chained && (G != 1 || 2LL * c.S * c.T >= (1LL << 31))) return (int)cudaErrorInvalidValue;
  return launch_scan(kernel, g, ring + pos, cuda_stream, c, (const int*)stream,
                     (long long*)states, tb, (int*)rolz, (uint8_t*)out,
                     (long long*)used, (int*)gpos, pos > 0, chained ? c.S * c.T : 0, bn);
}

extern "C" int cpx_k1_launch(const int* cfg, int G, const void* bn, const void* stream,
                             void* states, void* o2, void* o1, void* o3, void* len,
                             void* idx, void* sse, void* sse_h, void* rolz, void* out,
                             void* used, void* gpos, void* cuda_stream) {
  return k1_launch(cfg, G, (const int*)bn, stream, states, o2, o1, o3, len, idx, sse, sse_h,
                   rolz, out, used, gpos, cuda_stream, 0);
}

// The chain arm: out is the [2, S, T] window (region 0 the previous
// block's bytes), bucket positions and copy sources are window-absolute.
extern "C" int cpx_k1c_launch(const int* cfg, const void* stream, void* states,
                              void* o2, void* o1, void* o3, void* len, void* idx,
                              void* sse, void* sse_h, void* rolz, void* out,
                              void* used, void* gpos, void* cuda_stream) {
  return k1_launch(cfg, 1, nullptr, stream, states, o2, o1, o3, len, idx, sse, sse_h, rolz,
                   out, used, gpos, cuda_stream, 1);
}

#ifdef CPX_K1_PROF
// The instrumented build's phase sums (K1_PHASES counters of SM cycles,
// summed over every launch since the last call): copied into out, then
// set to 0.
extern "C" int cpx_k1_prof_read(void* out) {
  unsigned long long zero[K1_PHASES] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, k1_prof, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k1_prof, zero, sizeof(zero));
  return (int)e;
}
#endif

#ifdef CPX_K12D_PROF
// The instrumented build's phase sums of the tableless scan (2 *
// K12D_PHASES counters of SM cycles: thread 0's, then the last thread's,
// summed over every launch of the mode since the last call): copied into
// out, then set to 0.
extern "C" int cpx_k12d_prof_read(void* out) {
  return prof_read(out, k12d_prof, sizeof(k12d_prof));
}

extern "C" int cpx_k13d_prof_read(void* out) {
  return prof_read(out, k13d_prof, sizeof(k13d_prof));
}
#endif
