// K2: the forward modeling scan of encode, with an entry for mode R (K2),
// one for mode X (K12e) and one for mode P (K13e).
//
// Replaces comprox_tpu/codec/block.py::_encode_model_body (1677-1895) under
// the lax.scan of _encode_passes (1898-1941).  With
// the symbols known from the parse, each step reads the A (o2 + SSE), B (o1
// with exclusion, or the ROLZ index) and C (match length) distributions,
// emits the normalised (c, f, active) triple of each slot, then applies the
// shared model updates.  Output: ev [T, 9, S] int32.
//
// Mode X codes a match by its distance: B is the bucket floor(log2(dist))
// from one shared row of 32 counts, or symbol 24 where the distance is the
// lane's previous one; C's context is the bucket / 6; two more slots D and
// E carry the distance's mantissa bits (MantSplit in ppm_r.cuh), D through
// the adaptive [16, 16] table for buckets 5..16; the A event has the hit
// APM only.  D and E read the table as the step found it; every adaptive
// lane then adds to it (integer atomics in shared memory, where JAX takes
// one-hot products), and a row over its cap is halved after the adds.
// Output: ev [T, 15, S].
//
// Mode P (LZP) has no parse: each coding lane reads its one candidate from
// the three shared tables (block.py::_lzp_candidate, 362-403: three int32
// loads, up to 8 history bytes to verify), measures it against its next
// `window` bytes (_match_window_len, 1059-1068) and codes a match where it
// is at least min_len long.  A match has no source to code: B is the escape
// only, C the length under context 0.  The A event's hit APM is keyed by
// whether the lane has a candidate at all.  The step ends with the three
// scatter-max inserts of _post_step (662-676) as atomicMax: candidate reads
// and inserts are four barriers apart.  Output: ev [T, 9, S].
//
// The R branch reads its ROLZ index and bucket fill from the search pass
// (block.py:1704-1713), never the bucket table, so this kernel keeps no
// bucket table and does no bucket insert: the bytes are the same.
//
// Bound on the H100: T dependent steps in one CTA (above 1024 lanes one
// cluster of CTAs, ppm_r.cuh); per step a coding lane
// reads its 260-entry o2 row (and an escaping lane its 256-entry o1 row)
// and the step ends in four barriers.  Row loads by one thread per lane
// would touch 32 rows per warp load, so the o2 row of each coding lane is
// read by its whole warp (coalesced, warp reductions; the A event shared
// with K1).  The design keeps the small models (len, idx, APMs, o1 row
// sums) in shared memory, turns every table update into a winner-only
// store or an integer atomicAdd, and does an event's work only on the
// lanes that code it (JAX computes every lane and masks).
#include "rolz_search.cuh"

namespace {

// An instrumented build (-DCPX_K2_PROF, which the main path's build does
// not use; benchmarks/phases.py) stamps the SM clock at the end of each of the
// modeling scan's phases (ppm_r.cuh::PhaseClock), in every mode's entry.
#define K2_PHASES 10
#ifdef CPX_K2_PROF
__device__ unsigned long long k2_prof[2 * K2_PHASES];
#define K2_STAMP(k) clk_.mark(k);
#else
#define K2_STAMP(k)
#endif

// Slots D and E of a mode-X match lane (block.py::_mant_events_enc): the
// normalised events, and in u what the mantissa update needs.
static __device__ void mant_events(const SmemModel& sm, int dist, int k_dist,
                                   bool has_extra, Upd& u, uint32_t& cd,
                                   uint32_t& fd, bool& act_d, uint32_t& ce,
                                   uint32_t& fe, bool& act_e) {
  const MantSplit m = mant_split(k_dist, has_extra);
  const uint32_t e = (uint32_t)(dist - (1 << k_dist));
  act_d = has_extra && (m.adaptive || m.b_hi > 0);
  act_e = has_extra && m.b_e > 0;
  if (m.adaptive) {
    const int top4 = (int)(e >> max(k_dist - 4, 0)) & 15;
    const int* row = sm.mant + (k_dist - 5) * MANT_N;
    int cm_raw, fm_raw;
    cum_frq_of(PlainRow{row}, MANT_N, top4, cm_raw, fm_raw);
    norm_cf(cm_raw, max(fm_raw, 1), max(sum_prefix(PlainRow{row}, MANT_N), 1), cd, fd);
    u.adaptive = true;
    u.mant_row = k_dist - 5;
    u.mant_sym = top4;
  } else if (act_d) {
    fd = 1u << (15 - m.b_hi);
    cd = (e >> m.b_lo) * fd;
  }
  if (act_e) {
    fe = 1u << (15 - m.b_e);
    ce = (e & ((1u << m.b_e) - 1u)) * fe;
  }
}

template <int MAXT, int MODE, bool CL>
__global__ void __launch_bounds__(MAXT) k2_kernel(Cfg c, const uint8_t* __restrict__ inp,
                          const int* __restrict__ dec, Tables tb, Lzp lzp,
                          int* __restrict__ ev) {
  constexpr bool XMODE = MODE == MODE_X, PMODE = MODE == MODE_P;
  __shared__ SmemModel own;  // this CTA's keys; with CL, CTA 0's models serve all
  SmemModel& sm = *at_rank<CL>(&own, 0);
  extern __shared__ __align__(16) int dyn[];  // the warps' row rings
  const int i = gtid();
  const bool alive = i < c.S;
  __shared__ int sse_thr[33];  // the APM thresholds, for the A event's per-lane SSE
  model_load<MODE>(sm, tb);
  keyf_init(own.keyf);
  for (int k = threadIdx.x; k < 33; k += blockDim.x) sse_thr[k] = kSseThr[k];
  group_sync<CL>();
  const size_t plane = (size_t)c.T * c.S;
  const int n_ev = XMODE ? 15 : 9;
  uint32_t ctx4 = 0, ctx4b = 0;
  int copy_rem = 0, copy_src = 0, prev_dist = 1;
  // a step's o3 entry, decisions and byte, loaded in the step before's add
  // phase (after the o3 winners' stores; nothing writes them later), so
  // that the step does not open on a round trip
  int raw_n = 0, len_n = 0, src_n = 0, idx_n = 0, fill_n = 0, byte_n = 0;
  auto prefetch = [&](int tn) {
    if (!alive || tn >= c.T) return;
    const size_t o = (size_t)tn * c.S + i;
    raw_n = tb.o3[o3_slot(c, ctx4)];
    if (!PMODE && c.match) {
      len_n = dec[o];
      src_n = dec[plane + o];
      if (!XMODE) {
        idx_n = dec[2 * plane + o];
        fill_n = dec[3 * plane + o];
      }
    }
    byte_n = inp[(size_t)i * c.T + tn];
  };
  prefetch(0);
#ifdef CPX_K2_PROF
  __shared__ unsigned long long prof_[2 * K2_PHASES];
  PhaseClock<K2_PHASES> clk_;
  clk_.start(prof_);
#endif

  for (int t = 0; t < c.T; ++t) {
    o1_rescale(tb.o1, sm.o1sum, c.cap1);
    group_sync<CL>();
    K2_STAMP(0)

    Ctx x = contexts(c, i, t, ctx4, copy_rem, alive, raw_n);
    Upd u = {};
    int length = 0, src = 0, fill = 0, byte = 0, dist = 1, k_dist = 0;
    int c1_raw = 0, f1_raw = 0, tot1 = 0;
    uint32_t ca = 0, fa = RANS_M;
    const bool coding = alive && x.coding;
    RowRing ring = ring_start(dyn, tb.o2, O2_W, coding, x.ctx2);
    bool lzp_ok = false;
    if (alive) {
      if (PMODE) {
        if (coding && c.match) {
          lzp_ok = lzp_candidate(c, lzp, inp, t, ctx4, ctx4b, src);
          if (lzp_ok)
            length = min(prefix_len(inp, c, i, t, src, c.window), len_cap_at(c, i, t));
          if (length < c.min_len) length = 0;  // too short: a literal
        }
      } else if (c.match) {
        length = len_n;
        src = src_n;
        if (!XMODE) {
          u.sym_idx = idx_n;
          fill = fill_n;
        }
      }
      byte = byte_n;
      u.byte = byte;
      u.ctx2 = x.ctx2; u.p1 = x.p1; u.h3 = x.h3; u.pred = x.pred;
      u.conf = x.conf; u.raw = x.raw;
      if (XMODE) {
        if (coding && length > 0) dist = max(x.pos - src, 1);
        k_dist = dist_bucket(dist);
        u.len_ctx = min(k_dist / 6, 3);
      } else if (!PMODE) {
        u.idx_ctx = fill_bucket(fill);
        u.len_ctx = rec_bucket(u.sym_idx);
      }
      u.sym_len = clampi(length - c.min_len, 0, LEN_W - 1);
    }
    K2_STAMP(1)
    const AEvent a = warp_a_event<false, MODE>(
        c, ring, coding, x.ctx2, x.pred, x.conf,
        XMODE ? sse_x_ctx(x.conf, x.p1) : PMODE ? sse_p_ctx(x.conf, lzp_ok, x.p1) : fill,
        sm.sse, MODE == MODE_R ? sm.sse_h : sm.sse_x, 0u, byte, length > 0, sse_thr);
    if (coding) {
      u.sse = a.sse;
      u.halvings = a.h;
      const int sym_a = a.sym;
      norm_cf(a.c, max(a.f, 1), max(a.tot, 1), ca, fa);
      u.coding = true;
      u.sym_a = sym_a;
      u.f_byte = a.fbyte;
      u.is_lit = sym_a < 256;
      u.is_hit = sym_a == SYM_HIT;
      u.is_esc = sym_a == SYM_ESC;
      u.is_match = sym_a == SYM_MATCH;
      if (u.is_match) {
        if (XMODE) {
          mark_hot(&sm.hot_dst, &sm.dst_sum, c.dst_cap, &sm.due_idx);
        } else if (!PMODE) {
          const int ic = clampi(u.idx_ctx, 0, 3);
          mark_hot(&sm.hot_idx[ic], &sm.idx_sum[ic], c.idx_cap, &sm.due_idx);
        }
        const int lc = clampi(u.len_ctx, 0, 3);
        mark_hot(&sm.hot_len[lc], &sm.len_sum[lc], c.len_cap, &sm.due_len);
      }
    }
    K2_STAMP(2)
    // B, o1 part (the o1 table is final for this step after its rescale)
    ring = ring_start(dyn, tb.o1, O1_N, u.is_esc, x.p1);
    const O1Event b = warp_o1_event<false>(ring, u.is_esc, x.p1, a.ex, x.pred,
                                           x.pred2, x.conf2 > 0, 0u, byte);
    if (u.is_esc) {
      tot1 = b.tot;
      c1_raw = b.c;
      f1_raw = b.f;
    }
    K2_STAMP(3)
    upd_keys(own, alive, u);
    group_sync<CL>();
    K2_STAMP(4)

    if (sm.due_idx | sm.due_len) {  // the same on every thread: no barrier otherwise
      if (XMODE) dst_rescale(c, sm);
      else if (!PMODE) idx_rescale(c, sm);  // mode P never reads an idx row
      len_rescale(c, sm);
      group_sync<CL>();
    }
    K2_STAMP(5)

    // C (and B of a match): each match lane's (cum, freq) of its len
    // symbol, and of its idx symbol (mode R) or distance bucket (mode X),
    // by its whole warp
    const int lc = clampi(u.len_ctx, 0, 3), ic = clampi(u.idx_ctx, 0, 3);
    const bool repeat = XMODE && dist == prev_dist;
    if (XMODE && u.is_match) u.sym_dst = repeat ? SYM_DST_REPEAT : k_dist;
    int ci_raw = 0, fi_raw = 0, cl_raw = 0, fl_raw = 0;
    warp_cum_frq(u.is_match, sm.len, LEN_W, lc * LEN_W, u.sym_len, cl_raw, fl_raw);
    if (!PMODE)
      warp_cum_frq(u.is_match, XMODE ? sm.dst : sm.idx, XMODE ? DST_W : IDX_W,
                   XMODE ? 0 : ic * IDX_W, XMODE ? u.sym_dst : u.sym_idx, ci_raw, fi_raw);
    if (alive) {
      uint32_t cb = 0, fb = RANS_M, cc = 0, fc = RANS_M;
      uint32_t cd = 0, fd = RANS_M, ce = 0, fe = RANS_M;
      bool act_d = false, act_e = false;
      if (u.is_esc) norm_cf(c1_raw, max(f1_raw, 1), max(tot1, 1), cb, fb);
      if (u.is_match) {
        if (XMODE) {
          norm_cf(ci_raw, max(fi_raw, 1), max(sm.dst_sum, 1), cb, fb);
          mant_events(sm, dist, k_dist, !repeat, u, cd, fd, act_d, ce, fe, act_e);
        } else if (!PMODE) {
          norm_cf(ci_raw, max(fi_raw, 1), max(sm.idx_sum[ic], 1), cb, fb);
        }
        norm_cf(cl_raw, max(fl_raw, 1), max(sm.len_sum[lc], 1), cc, fc);
      }
      int* e = ev + (size_t)t * n_ev * c.S + i;
      e[0 * c.S] = (int)ca; e[1 * c.S] = (int)fa; e[2 * c.S] = x.coding;
      e[3 * c.S] = (int)cb; e[4 * c.S] = (int)fb;
      e[5 * c.S] = u.is_esc || (!PMODE && u.is_match);
      e[6 * c.S] = (int)cc; e[7 * c.S] = (int)fc; e[8 * c.S] = u.is_match;
      if (XMODE) {
        e[9 * c.S] = (int)cd; e[10 * c.S] = (int)fd; e[11 * c.S] = act_d;
        e[12 * c.S] = (int)ce; e[13 * c.S] = (int)fe; e[14 * c.S] = act_e;
      }
    }
    K2_STAMP(6)
    upd_store<CL>(tb, own, u);
    group_sync<CL>();
    K2_STAMP(7)

    if (alive) {
      upd_add<MODE>(c, tb, sm, own, u);
      // block.py::_post_step without a bucket insert
      copy_rem = u.is_match ? u.sym_len + (c.min_len - 1) : max(copy_rem - 1, 0);
      copy_src = u.is_match ? src + 1 : copy_src + 1;
      if (XMODE && u.is_match) prev_dist = dist;
      if (x.active) {
        ctx4b = (ctx4b << 8) | (ctx4 >> 24);
        ctx4 = (ctx4 << 8) | (uint32_t)byte;
      }
      if (PMODE && c.match) lzp_insert(c, lzp, x.active, t, x.pos, ctx4, ctx4b);
    }
    prefetch(t + 1);
    group_sync<CL>();
    K2_STAMP(8)
    upd_finish<MODE>(sm, c.mant_cap);
    K2_STAMP(9)
  }
#ifdef CPX_K2_PROF
  clk_.flush(k2_prof);
#endif
  group_sync<CL>();
  model_store<MODE>(sm, tb);
  if (CL) group_sync<CL>();  // CTA 0 stays until every CTA has read its models
}

}  // namespace

template <int MODE>
static int model_launch(const int* cfg, const void* inp, const void* dec,
                        const Tables& tb, void* ev, void* stream,
                        const Lzp& lzp = Lzp{nullptr, nullptr, nullptr}) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  const ScanGrid g = scan_grid(c.S);
  auto kernel = g.ctas > 1 ? k2_kernel<CPX_MAX_LANES, MODE, true>
              : g.threads <= 512 ? k2_kernel<512, MODE, false>
                                 : k2_kernel<CPX_MAX_LANES, MODE, false>;
  return launch_scan(kernel, g, ring_bytes(g.threads), stream, c, (const uint8_t*)inp,
                     (const int*)dec, tb, lzp, (int*)ev);
}

// Mode R: dec [4, T, S] (take, src, recency index, fill) -> ev [T, 9, S].
extern "C" int cpx_k2_launch(const int* cfg, const void* inp, const void* dec,
                             void* o2, void* o1, void* o3, void* len, void* idx,
                             void* sse, void* sse_h, void* ev, void* stream) {
  Tables tb{(int*)o2, (int*)o1, (int*)o3, (int*)len, (int*)idx, (int*)sse,
            (int*)sse_h, nullptr, nullptr, nullptr};
  return model_launch<MODE_R>(cfg, inp, dec, tb, ev, stream);
}

// Mode X: dec [2, T, S] (take, src) -> ev [T, 15, S]; three more tables.
extern "C" int cpx_k12e_launch(const int* cfg, const void* inp, const void* dec,
                               void* o2, void* o1, void* o3, void* len, void* idx,
                               void* sse, void* sse_h, void* dst, void* mant,
                               void* sse_x, void* ev, void* stream) {
  Tables tb{(int*)o2, (int*)o1, (int*)o3, (int*)len, (int*)idx, (int*)sse,
            (int*)sse_h, (int*)dst, (int*)mant, (int*)sse_x};
  return model_launch<MODE_X>(cfg, inp, dec, tb, ev, stream);
}

// Mode P: no decisions; the three LZP tables (null with the match layer
// off) -> ev [T, 9, S]; sse_p is the hit APM.
extern "C" int cpx_k13e_launch(const int* cfg, const void* inp, void* o2, void* o1,
                               void* o3, void* len, void* idx, void* sse_p,
                               void* lzp2, void* lzp4, void* lzp8, void* ev,
                               void* stream) {
  Tables tb{(int*)o2, (int*)o1, (int*)o3, (int*)len, (int*)idx, nullptr,
            nullptr, nullptr, nullptr, (int*)sse_p};
  return model_launch<MODE_P>(cfg, inp, nullptr, tb, ev, stream,
                              Lzp{(int*)lzp2, (int*)lzp4, (int*)lzp8});
}

#ifdef CPX_K2_PROF
// The instrumented build's phase sums (2 * K2_PHASES counters of SM
// cycles: thread 0's, then the last thread's, summed over every launch of
// K2, K12e or K13e since the last call): copied into out, then set to 0.
extern "C" int cpx_k2_prof_read(void* out) {
  return prof_read(out, k2_prof, sizeof(k2_prof));
}
#endif
