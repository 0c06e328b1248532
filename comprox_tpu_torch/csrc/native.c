/* Host helpers of the PyTorch port (comprox_tpu_torch).
 *
 * Host-side loops that are inherently sequential or branchy and so run in
 * C on the CPU, not on the card: the x86 E8/E9 call-target transform
 * (sequential 4-byte operand skip) and the dictionary stage's count,
 * substitution and expansion loops.  The port's own copy of the JAX
 * package's csrc/native.c entry points that the crz path uses; they are
 * not kernels.
 *
 * Built at first use by comprox_tpu_torch/utils/native.py with
 * cc -O3 -shared into build/native/; every entry point has a byte-identical
 * pure-Python path for a machine without a C compiler.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

/* x86 E8/E9 rel32 -> abs32 transform over buf[0..len), treating the region
 * as starting at virtual offset vbase within an image of size vsize.
 * Invertible by construction: encoded operands land in [0, vsize) for
 * in-image targets or (-vsize, 0) for the wrap class; decode reverses by
 * sign.  Opcode bytes are never modified, so both directions take identical
 * skip decisions.  en_de: 0 = encode, 1 = decode.
 */
void e8e9_transform(uint8_t *buf, int64_t len, int64_t vbase, int64_t vsize,
                    int en_de) {
    int64_t i = 0;
    if (len < 9) return;
    while (i < len - 8) {
        if ((buf[i++] & 0xFE) == 0xE8) {
            int32_t op;
            memcpy(&op, buf + i, 4);
            int64_t here = vbase + i;
            if (en_de == 0) {
                if (op >= -here && op < vsize - here) {
                    op = (int32_t)(op + here);
                } else if (op > 0 && op < vsize) {
                    op = (int32_t)(op - vsize);
                }
            } else {
                if (op < 0) {
                    if (op + here >= 0) op = (int32_t)(op + vsize);
                } else if (op < vsize) {
                    op = (int32_t)(op - here);
                }
            }
            memcpy(buf + i, &op, 4);
            i += 4;
        }
    }
}

/* ---------------------------------------------------------------------- */
/* Dictionary substitution loops (the sequential host stage of the        */
/* codec/dictionary.py scheme; the reference threads its equivalent,      */
/* cr-diccode.c:142-283).  Both directions are exact ports of the Python  */
/* reference implementation in codec/dictionary.py — archives must be     */
/* byte-identical whichever path runs.                                    */
/* ---------------------------------------------------------------------- */

#define DICT_ALPHA(c) (((c) >= 'A' && (c) <= 'Z') || ((c) >= 'a' && (c) <= 'z'))

static uint64_t dict_hash(const uint8_t *s, int64_t len) {
    uint64_t h = 1469598103934665603ull; /* FNV-1a */
    for (int64_t i = 0; i < len; i++) {
        h ^= s[i];
        h *= 1099511628211ull;
    }
    return h;
}

/* Open-addressing token table built per call (nwords <= ~66k: microseconds).
 * slots holds word indices + 1 (0 = empty). */
static int64_t dict_lookup(const int32_t *slots, int64_t nslots,
                           const uint8_t *words, const int64_t *woff,
                           const uint8_t *tok, int64_t tlen) {
    uint64_t h = dict_hash(tok, tlen) & (uint64_t)(nslots - 1);
    while (slots[h]) {
        int64_t w = slots[h] - 1;
        int64_t wl = woff[w + 1] - woff[w];
        if (wl == tlen && memcmp(words + woff[w], tok, tlen) == 0) return w;
        h = (h + 1) & (uint64_t)(nslots - 1);
    }
    return -1;
}

/* Substitute tokens ([A-Za-z]{2,20} plus an optional trailing space when
 * space_mode) with their codes; escape literal lead/cap bytes.  Capitalized
 * tokens fold to their lowercase entry and emit cap_byte + code.  Returns
 * bytes written (out_cap must be >= 2*n + 4).  slots is caller-provided
 * scratch of nslots int32 (nslots = power of two > 2*nwords). */
int64_t dict_encode_c(const uint8_t *inp, int64_t n, const uint8_t *words,
                      const int64_t *woff, int64_t nwords,
                      const uint8_t *codes, const int64_t *coff,
                      int32_t space_mode, int32_t cap_byte,
                      const uint8_t *esc_map, /* [256][3]: len,b0,b1 */
                      int32_t *slots, int64_t nslots, uint8_t *out) {
    int64_t o = 0, i = 0;
    memset(slots, 0, (size_t)nslots * sizeof(int32_t));
    for (int64_t w = 0; w < nwords; w++) {
        int64_t wl = woff[w + 1] - woff[w];
        uint64_t h = dict_hash(words + woff[w], wl) & (uint64_t)(nslots - 1);
        while (slots[h]) h = (h + 1) & (uint64_t)(nslots - 1);
        slots[h] = (int32_t)(w + 1);
    }
    while (i < n) {
        uint8_t c = inp[i];
        if (DICT_ALPHA(c) && i + 1 < n && DICT_ALPHA(inp[i + 1])) {
            int64_t tlen = 2;
            while (tlen < 20 && i + tlen < n && DICT_ALPHA(inp[i + tlen]))
                tlen++;
            if (space_mode && i + tlen < n && inp[i + tlen] == ' ') tlen++;
            int64_t w = dict_lookup(slots, nslots, words, woff, inp + i,
                                    tlen);
            uint8_t folded[21];
            if (w < 0 && cap_byte >= 0 && inp[i] >= 'A' && inp[i] <= 'Z') {
                /* fold candidate: rest (minus trailing space) all a-z */
                int64_t rl = tlen;
                if (inp[i + rl - 1] == ' ') rl--;
                int ok = 1;
                for (int64_t k = 1; k < rl; k++)
                    if (!(inp[i + k] >= 'a' && inp[i + k] <= 'z')) ok = 0;
                if (ok) {
                    memcpy(folded, inp + i, (size_t)tlen);
                    folded[0] += 32;
                    w = dict_lookup(slots, nslots, words, woff, folded,
                                    tlen);
                    if (w >= 0) out[o++] = (uint8_t)cap_byte;
                }
            }
            if (w >= 0) {
                int64_t cl = coff[w + 1] - coff[w];
                memcpy(out + o, codes + coff[w], (size_t)cl);
                o += cl;
            } else {
                for (int64_t k = 0; k < tlen; k++) {
                    const uint8_t *e = esc_map + 3 * inp[i + k];
                    out[o++] = e[1];
                    if (e[0] == 2) out[o++] = e[2];
                }
            }
            i += tlen;
        } else {
            const uint8_t *e = esc_map + 3 * c;
            out[o++] = e[1];
            if (e[0] == 2) out[o++] = e[2];
            i++;
        }
    }
    return o;
}

/* Expand codes back to words.  Tables: one_map[256] / two_map[nleads*256]
 * hold word index + 1 (0 = not a code); lead_idx[256] = lead index or 255;
 * cap_byte < 0 disables the capitalization mark.  When out is NULL only
 * counts the output size.  Returns bytes (to be) written. */
int64_t dict_decode_c(const uint8_t *inp, int64_t n, const uint8_t *words,
                      const int64_t *woff, const int32_t *one_map,
                      const int32_t *two_map, const uint8_t *lead_idx,
                      int32_t cap_byte, uint8_t *out) {
    int64_t o = 0, i = 0;
    while (i < n) {
        uint8_t c = inp[i];
        int capped = (cap_byte >= 0 && c == (uint8_t)cap_byte);
        if (capped) {
            i++;
            if (i >= n) break; /* dangling cap mark: drop (fail-soft) */
            c = inp[i];
        }
        int64_t w = -1;
        if (lead_idx[c] != 255) {
            uint8_t cb = (i + 1 < n) ? inp[i + 1] : 0;
            w = (int64_t)two_map[(int64_t)lead_idx[c] * 256 + cb] - 1;
            i += 2;
        } else if (one_map[c]) {
            w = (int64_t)one_map[c] - 1;
            i += 1;
        } else {
            if (capped) { /* cap before a non-code byte: drop the mark */
                continue;
            }
            if (out) out[o] = c;
            o++;
            i++;
            continue;
        }
        if (w >= 0) {
            int64_t wl = woff[w + 1] - woff[w];
            if (out) {
                memcpy(out + o, words + woff[w], (size_t)wl);
                if (capped && wl && out[o] >= 'a' && out[o] <= 'z')
                    out[o] -= 32;
            }
            o += wl;
        }
    }
    return o;
}

/* Count unique tokens for the dictionary-builder pass (the sequential
 * analogue of cr-dicpick.c:149-216's streamed count; the Python regex +
 * Counter pass is the slowest host stage of a dict-on encode).  Tokenizer identical to dict_encode_c above
 * ([A-Za-z]{2,20} plus an optional trailing space when space_mode);
 * fold_mode folds Capitalized tokens (first-upper + rest-lower) onto
 * their lowercase form AT COUNT TIME — arithmetic identical to the
 * Python path's count-raw-then-fold-unique merge, and tokens are
 * recorded in first-occurrence order of the folded key so downstream
 * stable sorts tie-break identically.
 *
 * Outputs: arena = concatenated unique tokens, lens[i] / counts[i] per
 * token.  Returns the number of unique tokens, or -1 when a capacity or
 * allocation limit is hit (caller falls back to the Python pass). */
int64_t dict_count_c(const uint8_t *inp, int64_t n, int32_t space_mode,
                     int32_t fold_mode, uint8_t *arena, int64_t arena_cap,
                     int32_t *lens, int64_t *counts, int64_t max_entries) {
    int64_t nslots = 1;
    while (nslots < 2 * max_entries) nslots <<= 1;
    int64_t *slots = (int64_t *)malloc((size_t)nslots * sizeof(int64_t));
    int64_t *offs = (int64_t *)malloc((size_t)(max_entries + 1) *
                                      sizeof(int64_t));
    if (!slots || !offs) {
        free(slots);
        free(offs);
        return -1;
    }
    memset(slots, 0, (size_t)nslots * sizeof(int64_t));
    int64_t ne = 0, ao = 0, i = 0;
    offs[0] = 0;
    uint8_t tokbuf[21];
    while (i < n) {
        uint8_t c = inp[i];
        if (DICT_ALPHA(c) && i + 1 < n && DICT_ALPHA(inp[i + 1])) {
            int64_t tlen = 2;
            while (tlen < 20 && i + tlen < n && DICT_ALPHA(inp[i + tlen]))
                tlen++;
            if (space_mode && i + tlen < n && inp[i + tlen] == ' ') tlen++;
            const uint8_t *tok = inp + i;
            if (fold_mode && c >= 'A' && c <= 'Z') {
                int64_t rl = tlen;
                if (tok[rl - 1] == ' ') rl--;
                int ok = 1;
                for (int64_t k = 1; k < rl; k++)
                    if (!(tok[k] >= 'a' && tok[k] <= 'z')) ok = 0;
                if (ok) {
                    memcpy(tokbuf, tok, (size_t)tlen);
                    tokbuf[0] += 32;
                    tok = tokbuf;
                }
            }
            uint64_t h = dict_hash(tok, tlen) & (uint64_t)(nslots - 1);
            for (;;) {
                if (!slots[h]) {
                    if (ne >= max_entries || ao + tlen > arena_cap) {
                        free(slots);
                        free(offs);
                        return -1;
                    }
                    memcpy(arena + ao, tok, (size_t)tlen);
                    lens[ne] = (int32_t)tlen;
                    counts[ne] = 1;
                    ao += tlen;
                    offs[ne + 1] = ao;
                    slots[h] = ++ne;
                    break;
                }
                int64_t e = slots[h] - 1;
                if (offs[e + 1] - offs[e] == tlen &&
                    memcmp(arena + offs[e], tok, (size_t)tlen) == 0) {
                    counts[e]++;
                    break;
                }
                h = (h + 1) & (uint64_t)(nslots - 1);
            }
            i += tlen;
        } else {
            i++;
        }
    }
    free(slots);
    free(offs);
    return ne;
}

/* ---------------------------------------------------------------------- */
/* Mode-F sequence executor (decode half of the fast profile).            */
/*                                                                        */
/* The device entropy-decodes the tokens (comprox_tpu_torch/codec/fast.py)*/
/* and ships one u32 per token: values < 256 are literal bytes; values >= */
/* 256 are matches packed (dist << 8) | (len - min_len), dist >= 1, the   */
/* repeat distances already resolved.  This walk materializes the output  */
/* bytes: the LZ copy chain is the one sequential dependency of the       */
/* profile, and a host core does it at memcpy speed.                      */
/*                                                                        */
/* Returns the number of bytes written, or -1 on a malformed token stream */
/* (source underrun or output overrun): it never reads or writes out of   */
/* bounds on corrupt input.                                               */
int64_t f2_execute(const uint32_t *tok, int64_t n_tok, int64_t min_len,
                   uint8_t *out, int64_t out_cap) {
    int64_t o = 0;
    for (int64_t i = 0; i < n_tok; i++) {
        uint32_t v = tok[i];
        if (v < 256u) {
            if (o >= out_cap) return -1;
            out[o++] = (uint8_t)v;
        } else {
            int64_t len = (int64_t)(v & 255) + min_len;
            int64_t dist = (int64_t)(v >> 8); /* >= 1 since v >= 256 */
            int64_t src = o - dist;
            if (src < 0 || o + len > out_cap) return -1;
            /* forward byte copy: an overlap (dist < len) replicates */
            for (int64_t j = 0; j < len; j++) out[o + j] = out[src + j];
            o += len;
        }
    }
    return o;
}
