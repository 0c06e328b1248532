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
// SmemModel, K1 uses 230,000 of the H100's 232,448 B of shared memory a
// CTA at S=512, rolz_depth 64 (cpx_k1_launch moves the copies to device
// memory where they do not fit).
//
// Mode X (k12d_kernel) keeps no match table: a match lane decodes its
// distance — B: the bucket, or symbol 24 for the lane's previous distance;
// C: the length, under the context bucket / 6; D and E: the mantissa bits
// (MantSplit in ppm_r.cuh), D through the adaptive [16, 16] table for
// buckets 5..16 — and copies from pos - dist of the output.  Five
// lane-ordered word reads a step, so five CTA-wide prefixes; the window
// start of each is clamped as lax.dynamic_slice clamps it.  The mantissa
// table is read as the step found it, then every adaptive lane adds to it
// (integer atomics in shared memory) and a row over its cap is halved.  A
// lane that codes no match runs none of the B (distance), C, D, E symbol
// searches: whatever JAX computes there is masked before any table sees it.
//
// Mode P (the same kernel, MODE_P): before the A event each coding lane
// reads its LZP candidate (block.py:2016-2021; ppm_r.cuh::lzp_candidate)
// from the three shared tables and verifies it against the output bytes of
// earlier steps, because the hit APM is keyed by whether there is one; a
// match (A, then C under context 0: three word reads a step) copies from
// that source.  The step's column is written after a barrier that follows
// every read of the output, and the scatter-max inserts (atomicMax) come
// after it, two barriers before the next step's candidate reads.
#include "ppm_r.cuh"

namespace {

struct StreamRead {
  const int* stream;
  int len, lanes;
  // Word for lane-order index excl of a window starting at base + off,
  // with the start clamped as lax.dynamic_slice clamps it.
  __device__ uint32_t word(uint32_t start, int excl) const {
    long long s = start >= 0x80000000u ? 0 : (long long)start;
    s = max(0LL, min(s, (long long)(len - lanes)));
    return (uint32_t)stream[s + excl] & 0xFFFFu;
  }
};

// An instrumented build (-DCPX_K1_PROF, which the main path's build does
// not use; benchmarks/k1_phases.py) stamps clock64() at the end of each of
// K1's phases on thread 0 (CTA 0), sums each phase over the steps and adds
// the sums to k1_prof at the end of the launch.
#define K1_PHASES 12
#ifdef CPX_K1_PROF
__device__ unsigned long long k1_prof[K1_PHASES];
#define K1_STAMP(k)                                   \
  if (gtid() == 0) {                                  \
    const long long now_ = clock64();                 \
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
                          bool pos_in_smem) {
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
  const long long cap_n = (long long)c.S * c.T;
  const StreamRead sr{stream, c.stream_len, c.S};
  model_load(sm, tb);
  group_sync<CL>();
  uint32_t x = alive ? (uint32_t)states[i] : RANS_L;
  uint32_t base = 0;
  uint32_t ctx4 = 0, ctx4b = 0;
  int copy_rem = 0, copy_src = 0;
#ifdef CPX_K1_PROF
  stamp_ = clock64();
#endif
  // the lanes' copies of bucket rows: the A event's row until the byte is
  // resolved, then the insert row
  const int pitch = pos_pitch(d);
  int* const posbuf = pos_bufs<CL>(c, spos, gpos, pos_in_smem, pitch).pos;
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
      if (u.is_match) sm.hot_idx[clampi(u.idx_ctx, 0, 3)] = 1;
    }
    upd_keys(own, alive, u);
    group_sync<CL>();
    idx_rescale(c, sm);
    group_sync<CL>();
    K1_STAMP(4)

    // ---- B event: o1 literal (escape lanes) or ROLZ index (match lanes)
    int sym1 = 0;
    need = false;
    const O1Event b = warp_o1_event<true>(ring, u.is_esc, cx.p1, a.ex, cx.pred,
                                          cx.pred2, cx.conf2 > 0, x, 0);
    if (alive) {
      uint32_t cb = 0, fb = RANS_M;
      if (u.is_esc) {
        sym1 = b.sym;
        norm_cf(b.c, max(b.f, 1), max(b.tot, 1), cb, fb);
      } else if (u.is_match) {
        int ic = clampi(u.idx_ctx, 0, 3);
        int tot_i = sm.idx_sum[ic];
        int ci_raw, fi_raw;
        u.sym_idx = find_symbol(PlainRow{sm.idx + ic * IDX_W}, IDX_W,
                                (int)dec_target(x, max(tot_i, 1)), ci_raw, fi_raw);
        u.len_ctx = rec_bucket(u.sym_idx);
        norm_cf(ci_raw, max(fi_raw, 1), max(tot_i, 1), cb, fb);
        sm.hot_len[clampi(u.len_ctx, 0, 3)] = 1;
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
    len_rescale(c, sm);
    group_sync<CL>();
    K1_STAMP(6)

    // ---- C event: match length
    int sym_l = 0;
    need = false;
    if (alive) {
      uint32_t cc = 0, fc = RANS_M;
      if (u.is_match) {
        int lc = clampi(u.len_ctx, 0, 3);
        int tot_l = sm.len_sum[lc];
        int cl_raw, fl_raw;
        sym_l = find_symbol(PlainRow{sm.len + lc * LEN_W}, LEN_W,
                            (int)dec_target(x, max(tot_l, 1)), cl_raw, fl_raw);
        norm_cf(cl_raw, max(fl_raw, 1), max(tot_l, 1), cc, fc);
      }
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
    own.key_ins[threadIdx.x] = ins_key;
    group_sync<CL>();
    K1_STAMP(8)
    int slot = bucket_slot<CL>(rolz, c, own.key_ins, ins_key, posbuf, pitch);
    group_sync<CL>();
    K1_STAMP(9)

    // ---- stores, then additive updates
    if (alive) {
      upd_store<CL>(tb, own, u);
      if (slot >= 0) bucket_store(rolz, c, (uint32_t)ins_key, slot, cx.pos, byteswap32(ctx4n));
      out[(size_t)i * c.T + t] = (uint8_t)(cx.active ? byte : 0);
    }
    group_sync<CL>();
    K1_STAMP(10)
    if (alive) {
      upd_add(c, tb, sm, u);
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
  if (gtid() < K1_PHASES) atomicAdd(&k1_prof[gtid()], prof_[gtid()]);
#endif
  model_store(sm, tb);
  if (alive) states[i] = (long long)x;
  if (i == 0) *used = (long long)base;
  if (CL) group_sync<CL>();  // CTA 0 stays until every CTA has read its models
}

// Feed one word to every lane whose advanced state xt fell below the rANS
// lower bound, in lane order from the stream position base (one CTA-wide
// exclusive prefix; contains a barrier: call by every thread).
#define CPX_RENORM(slot)                                         \
  {                                                              \
    const int inw_ = cta_excl_prefix_a(need, own.wtot[slot]);    \
    group_sync<CL>();                                            \
    int total_;                                                  \
    const int ex_ = cta_excl_prefix_b<CL>(inw_, own.wtot[slot], total_); \
    if (need) x = (xt << 16) | sr.word(base, ex_);               \
    else if (alive) x = xt;                                      \
    base += (uint32_t)total_;                                    \
  }

template <int MAXT, int MODE, bool CL>
__global__ void __launch_bounds__(MAXT) k12d_kernel(Cfg c, const int* __restrict__ stream,
                            long long* __restrict__ states, Tables tb, Lzp lzp,
                            uint8_t* __restrict__ out,
                            long long* __restrict__ used) {
  constexpr bool XMODE = MODE == MODE_X;
  __shared__ SmemModel own;  // this CTA's keys and wtot; with CL, CTA 0's models serve all
  SmemModel& sm = *at_rank<CL>(&own, 0);
  extern __shared__ __align__(16) int dyn[];  // the warps' row rings
  const int i = gtid();
  const bool alive = i < c.S;
  const long long cap_n = (long long)c.S * c.T;
  const StreamRead sr{stream, c.stream_len, c.S};
  model_load<MODE>(sm, tb);
  group_sync<CL>();
  uint32_t x = alive ? (uint32_t)states[i] : RANS_L;
  uint32_t base = 0;
  uint32_t ctx4 = 0, ctx4b = 0;
  int copy_rem = 0, copy_src = 0, prev_dist = 1;

  for (int t = 0; t < c.T; ++t) {
    o1_rescale(tb.o1, sm.o1sum, c.cap1);
    group_sync<CL>();

    // ---- A event
    Ctx cx = common_reads(c, tb, i, t, ctx4, copy_rem, alive);
    Upd u = {};
    uint32_t xt = 0;
    bool need = false;
    const bool coding = alive && cx.coding;
    RowRing ring = ring_start(dyn, tb.o2, O2_W, coding, cx.ctx2);
    int lzp_src = 0;
    bool lzp_ok = false;
    if (!XMODE && coding && c.match)
      lzp_ok = lzp_candidate(c, lzp, out, t, ctx4, ctx4b, lzp_src);
    const AEvent a = warp_a_event<true, MODE>(
        c, ring, coding, cx.ctx2, cx.pred, cx.conf,
        XMODE ? sse_x_ctx(cx.conf, cx.p1) : sse_p_ctx(cx.conf, lzp_ok, cx.p1),
        sm.sse, sm.sse_x, x, 0, false);
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
    CPX_RENORM(0)
    if (alive) {
      u.coding = cx.coding;
      u.is_lit = cx.coding && u.sym_a < 256;
      u.is_hit = cx.coding && u.sym_a == SYM_HIT;
      u.is_esc = cx.coding && u.sym_a == SYM_ESC;
      u.is_match = cx.coding && u.sym_a == SYM_MATCH;
      u.ctx2 = cx.ctx2; u.p1 = cx.p1; u.h3 = cx.h3; u.pred = cx.pred;
      u.conf = cx.conf; u.raw = cx.raw;
      if (u.is_match) {
        if (XMODE) sm.hot_dst = 1;
        else sm.hot_len[0] = 1;  // mode P: C's one context
      }
    }
    upd_keys(own, alive, u);
    if (XMODE) {
      group_sync<CL>();
      dst_rescale(c, sm);
      group_sync<CL>();
    }

    // ---- B event: o1 literal (escape lanes); mode X: or the distance
    // bucket (match lanes)
    int sym1 = 0;
    need = false;
    const O1Event b = warp_o1_event<true>(ring, u.is_esc, cx.p1, a.ex, cx.pred,
                                          cx.pred2, cx.conf2 > 0, x, 0);
    if (alive) {
      uint32_t cb = 0, fb = RANS_M;
      if (u.is_esc) {
        sym1 = b.sym;
        norm_cf(b.c, max(b.f, 1), max(b.tot, 1), cb, fb);
      } else if (XMODE && u.is_match) {
        int cd_raw, fd_raw;
        u.sym_dst = find_symbol(PlainRow{sm.dst}, DST_W,
                                (int)dec_target(x, max(sm.dst_sum, 1)), cd_raw, fd_raw);
        norm_cf(cd_raw, max(fd_raw, 1), max(sm.dst_sum, 1), cb, fb);
        const int k_pre = clampi(
            u.sym_dst == SYM_DST_REPEAT ? dist_bucket(prev_dist) : u.sym_dst, 0, 24);
        u.len_ctx = min(k_pre / 6, 3);
        sm.hot_len[u.len_ctx] = 1;
      }
      xt = dec_advance(x, cb, fb);
      need = xt < RANS_L;
    }
    CPX_RENORM(1)
    len_rescale(c, sm);
    group_sync<CL>();

    // ---- C event: match length
    int sym_l = 0;
    need = false;
    if (alive) {
      uint32_t cc = 0, fc = RANS_M;
      if (u.is_match) {
        int lc = clampi(u.len_ctx, 0, 3);
        int tot_l = sm.len_sum[lc];
        int cl_raw, fl_raw;
        sym_l = find_symbol(PlainRow{sm.len + lc * LEN_W}, LEN_W,
                            (int)dec_target(x, max(tot_l, 1)), cl_raw, fl_raw);
        norm_cf(cl_raw, max(fl_raw, 1), max(tot_l, 1), cc, fc);
      }
      xt = dec_advance(x, cc, fc);
      need = xt < RANS_L;
    }
    CPX_RENORM(2)

    // ---- D event: the mantissa's top bits (adaptive or uniform)
    const bool repeat = XMODE && u.is_match && u.sym_dst == SYM_DST_REPEAT;
    const int k_dist = clampi(repeat ? 0 : u.sym_dst, 0, 24);
    const bool has_extra = XMODE && u.is_match && !repeat;
    const MantSplit ms = mant_split(k_dist, has_extra);
    int sym_m = 0, e_hi = 0, e_lo = 0;
    if (XMODE) {
      need = false;
      if (alive) {
        uint32_t cd = 0, fd = RANS_M;
        if (ms.adaptive) {
          const int* row = sm.mant + (k_dist - 5) * MANT_N;
          const int tot_m = sum_prefix(PlainRow{row}, MANT_N);
          int cm_raw, fm_raw;
          sym_m = find_symbol(PlainRow{row}, MANT_N,
                              (int)dec_target(x, max(tot_m, 1)), cm_raw, fm_raw);
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

    // ---- the distance (mode P: the candidate); resolve the byte; prepare
    // the updates
    int byte = 0, src = 0, dist = 1;
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
    }
    group_sync<CL>();  // every copy has read the output before this step's write

    // ---- stores, then additive updates
    if (alive) {
      upd_store<CL>(tb, own, u);
      out[(size_t)i * c.T + t] = (uint8_t)(cx.active ? byte : 0);
    }
    group_sync<CL>();
    if (alive) {
      upd_add<MODE>(c, tb, sm, u);
      copy_rem = u.is_match ? u.sym_len + (c.min_len - 1) : max(copy_rem - 1, 0);
      copy_src = u.is_match ? src + 1 : copy_src + 1;
      if (u.is_match) prev_dist = dist;
      ctx4 = ctx4n;
      ctx4b = ctx4bn;
      if (!XMODE && c.match) lzp_insert(c, lzp, cx.active, t, cx.pos, ctx4, ctx4b);
    }
    group_sync<CL>();
    upd_finish<MODE>(sm, c.mant_cap);
  }
  group_sync<CL>();
  model_store<MODE>(sm, tb);
  if (alive) states[i] = (long long)x;
  if (i == 0) *used = (long long)base;
  if (CL) group_sync<CL>();  // CTA 0 stays until every CTA has read its models
}

}  // namespace

template <int MODE>
static int tableless_launch(const int* cfg, const void* stream, void* states,
                            const Tables& tb, const Lzp& lzp, void* out,
                            void* used, void* cuda_stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  const ScanGrid g = scan_grid(c.S);
  auto kernel = g.ctas > 1 ? k12d_kernel<CPX_MAX_LANES, MODE, true>
              : g.threads <= 512 ? k12d_kernel<512, MODE, false>
                                 : k12d_kernel<CPX_MAX_LANES, MODE, false>;
  return launch_scan(kernel, g, ring_bytes(g.threads), cuda_stream, c,
                     (const int*)stream, (long long*)states, tb, lzp, (uint8_t*)out,
                     (long long*)used);
}

// Mode X: no bucket table; three more model tables.
extern "C" int cpx_k12d_launch(const int* cfg, const void* stream, void* states,
                               void* o2, void* o1, void* o3, void* len, void* idx,
                               void* sse, void* sse_h, void* dst, void* mant,
                               void* sse_x, void* out, void* used,
                               void* cuda_stream) {
  Tables tb{(int*)o2, (int*)o1, (int*)o3, (int*)len, (int*)idx, (int*)sse,
            (int*)sse_h, (int*)dst, (int*)mant, (int*)sse_x};
  return tableless_launch<MODE_X>(cfg, stream, states, tb,
                                  Lzp{nullptr, nullptr, nullptr}, out, used,
                                  cuda_stream);
}

// Mode P: the three LZP tables (null with the match layer off); sse_p is
// the hit APM.
extern "C" int cpx_k13d_launch(const int* cfg, const void* stream, void* states,
                               void* o2, void* o1, void* o3, void* len, void* idx,
                               void* sse_p, void* lzp2, void* lzp4, void* lzp8,
                               void* out, void* used, void* cuda_stream) {
  Tables tb{(int*)o2, (int*)o1, (int*)o3, (int*)len, (int*)idx, nullptr,
            nullptr, nullptr, nullptr, (int*)sse_p};
  return tableless_launch<MODE_P>(cfg, stream, states, tb,
                                  Lzp{(int*)lzp2, (int*)lzp4, (int*)lzp8}, out,
                                  used, cuda_stream);
}

extern "C" int cpx_k1_launch(const int* cfg, const void* stream, void* states,
                             void* o2, void* o1, void* o3, void* len, void* idx,
                             void* sse, void* sse_h, void* rolz, void* out,
                             void* used, void* gpos, void* cuda_stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  Tables tb{(int*)o2, (int*)o1, (int*)o3, (int*)len, (int*)idx, (int*)sse,
            (int*)sse_h, nullptr, nullptr, nullptr};
  const ScanGrid g = scan_grid(c.S);
  // the rings, then the lanes' bucket-row copies where they fit beside the
  // rings and the static SmemModel (else in gpos)
  const size_t ring = ring_bytes(g.threads);
  size_t pos = pos_smem_bytes(c);
  if (ring + pos + sizeof(SmemModel) + 256 > CPX_SMEM_MAX) pos = 0;
  auto kernel = g.ctas > 1 ? k1_kernel<CPX_MAX_LANES, true>
              : g.threads <= 512 ? k1_kernel<512, false> : k1_kernel<CPX_MAX_LANES, false>;
  return launch_scan(kernel, g, ring + pos, cuda_stream, c, (const int*)stream,
                     (long long*)states, tb, (int*)rolz, (uint8_t*)out,
                     (long long*)used, (int*)gpos, pos > 0);
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
