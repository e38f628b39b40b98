// The qwire frame step's two Huffman row decoders in one kernel.
//
// Replaces no TPU kernel: the JAX package decodes these rows with whole-
// array ops (heaac_tpu/ops/sbr_huff.py decode_sbr_rows_jax,
// heaac_tpu/ops/ps_huff.py decode_ps_region_jax), and the port's plain
// versions (ops/sbr_huff.py decode_sbr_rows, ops/ps_huff.py
// decode_ps_region) classify every bit offset of a row's window and
// resolve the code starts by pointer jumping: ~70-90 small kernels a row,
// ~4,800 a frame step, which made the step's time a count of launches.
// Here each lane's regions are read with a serial bit reader, once a step:
//   SBR: one element's dtdf flags, envelope and noise-floor rows (with
//        `pair`, the coupled channel's after the first's) -> ecodes
//        [B,5,48], pcodes, qcodes [B,2,5], qpcodes, ok [B] (bool) and the
//        rows carry (env_last [B,2,48], noise_last [B,2,5], fr_last [B,2]);
//   PS:  iid / icc rows, the extension container's ipd / opd rows, the
//        fake-envelope fixup -> iid [B,5,34], icc, ipd [B,5,17], opd,
//        pd_on [B], ps_ok [B] and the PS carry (iid_last, icc_last
//        [B,34], ipd_full, opd_full [B,5,17], pd_enable [B]).
// Every integer is int64 as in the plain versions, and the outputs equal
// theirs on every input, legal or not: a row whose codes run past its
// window (or whose last code ends on it), or that meets a LUT entry of
// length 31, is bad; byte reads clamp to the region; read_bits takes a
// 24-bit window and the code lookup a 32-bit one; a row decodes
// min(count, nsyms) codes.
//
// Bound.  The work is serial along a lane's bits: each code is a read of
// the region's bytes, then a LUT read at an index that depends on them,
// then the next position.  So a launch takes one lane's chain of
// dependent loads (~40-400 codes a frame) and its loops over every
// column of every row, not bytes or operations: the inputs and outputs
// of 256 lanes are 5.4 MB, 1.6 us at 3.35 TB/s.  Measured on an H100 SXM
// (700 W, tools/qwire_rows_check.py, the v2_batch_512 streams): 153 us
// warm and 180 us cold at 256 lanes, 182-183 us at 1024, about 1% of
// that bound; a first design that read each row back from the global
// outputs, with no prefix table, took 227-307 us.
//
// Design.  One thread per (lane, region): a block holds kLanes lanes, its
// first warp runs their SBR regions and its second their PS regions, so
// a lane's two decodes run side by side.  Inputs are read through the
// read-only path, and every output element is written once and never
// read back: the previous row a time-delta row needs is kept in the
// thread's own (L1-cached) local memory, and the PS fake-envelope fixup
// and masks are applied as each row is written (the row a fixup copies
// is the previous row then).  A code is looked up first in a prefix table of the table's
// top 8 bits (kPrefixBits; 5 KB for each of SBR and PS, L1-resident),
// which resolves every code of up to 8 bits, and only longer codes reach
// the flat LUT (7.7 MB for SBR, 3.3 MB for PS, as int16: L2 once
// touched).  Nothing is uploaded or allocated here: the launch is
// captured in the step's CUDA graph.

#include <cuda_runtime.h>

typedef long long i64;

// The kernel's arguments, one pointer each ([B] int64 unless stated); the
// field order is ops/qwire_rows.py FIELDS (a CPU test compares them).
struct RowsArgs {
  // SBR region [B,640] and controls (decode_sbr_rows)
  const i64* sbr_region;
  const i64* sbr_phase;
  const i64* sbr_rbits;
  const i64* sbr_ne;
  const i64* sbr_nnoise;
  const i64* sbr_frbits;
  const i64* sbr_n0;
  const i64* sbr_n1;
  const i64* sbr_nq;
  const i64* sbr_ampres;
  const bool* sbr_active;
  const i64* sbr_coupled;     // read only with pair
  const i64* sbr_env_last;    // [B,2,48]
  const i64* sbr_noise_last;  // [B,2,5]
  const i64* sbr_fr_last;     // [B,2]
  // PS region [B,288] and controls (decode_ps_region)
  const i64* ps_region;
  const i64* ps_start_off;
  const i64* ps_rbits;
  const i64* ps_enable_iid;
  const i64* ps_iq;
  const i64* ps_nr_iid;
  const i64* ps_enable_icc;
  const i64* ps_nr_icc;
  const i64* ps_enable_ext;
  const i64* ps_ne_pre;
  const i64* ps_penv;
  const i64* ps_nipd;
  const i64* ps_header;
  const i64* ps_iid_last;     // [B,34]
  const i64* ps_icc_last;     // [B,34]
  const i64* ps_ipd_full;     // [B,5,17]
  const i64* ps_opd_full;     // [B,5,17]
  const i64* ps_pd_enable;
  const i64* ps_penv_prev;
  const i64* ps_ps_ok;
  // LUTs (tables.sbr_huff_luts / ps_huff_luts): flat entries, the entries
  // of codes of up to kPrefixBits bits by each table's top bits, per-table
  // base and max code length, SBR_LAV, the PS symbol offsets, the iid
  // table by 2 * dt + iq
  const short* sbr_flat;
  const short* sbr_prefix;    // [10, 2^kPrefixBits]: entry, or -1
  const int* sbr_bases;
  const int* sbr_maxlens;
  const int* sbr_lav;
  const short* ps_flat;
  const short* ps_prefix;
  const int* ps_bases;
  const int* ps_maxlens;
  const int* ps_offsets;
  const int* ps_iid_tabsel;
  // SBR outputs
  i64* sbr_ecodes;            // [B,5,48]
  i64* sbr_pcodes;            // [B,5,48]
  i64* sbr_qcodes;            // [B,2,5]
  i64* sbr_qpcodes;           // [B,2,5]
  bool* sbr_ok;
  i64* sbr_env_last_out;      // [B,2,48]
  i64* sbr_noise_last_out;    // [B,2,5]
  i64* sbr_fr_last_out;       // [B,2]
  // PS outputs
  i64* ps_iid;                // [B,5,34]
  i64* ps_icc;                // [B,5,34]
  i64* ps_ipd;                // [B,5,17]
  i64* ps_opd;                // [B,5,17]
  i64* ps_pd_on;
  i64* ps_iid_last_out;       // [B,34]
  i64* ps_icc_last_out;       // [B,34]
  i64* ps_ipd_full_out;       // [B,5,17]
  i64* ps_opd_full_out;       // [B,5,17]
  i64* ps_pd_enable_out;
  i64* ps_ps_ok_out;          // also decode_ps_region's ps_on_ok
};

namespace {

constexpr int kLanes = 32;      // lanes a block: one warp a region
constexpr int kPrefixBits = 8;  // ops/qwire_rows.py PREFIX_BITS

// ops/sbr_huff.py
constexpr int kSbrRW = 640;   // region bytes
constexpr int kWEnv = 960;    // envelope row window, bits
constexpr int kWNoi = 112;    // noise row window, bits
constexpr int kE = 5;         // envelopes
constexpr int kNQ = 5;        // noise bands
constexpr int kNB = 48;       // envelope bands
enum { T_ENV15, F_ENV15, T_BAL15, F_BAL15, T_ENV30, F_ENV30, T_BAL30,
       F_BAL30, T_NOISE30, T_NOISEBAL30 };
// ops/ps_huff.py
constexpr int kPsRW = 288;
constexpr int kWRow = 704;    // iid / icc row window, bits
constexpr int kWPd = 96;      // ipd / opd row window, bits
enum { IID_DF1, IID_DT1, IID_DF0, IID_DT0, ICC_DF, ICC_DT, IPD_DF, IPD_DT,
       OPD_DF, OPD_DT };

template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldg(p); }
__device__ __forceinline__ bool ld(const bool* p) {
  return __ldg(reinterpret_cast<const unsigned char*>(p)) != 0;
}
__device__ __forceinline__ i64 shl(i64 x, int s) {  // wraps, as torch's <<
  return (i64)((unsigned long long)x << s);
}
__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }
__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }
__device__ __forceinline__ i64 clampi(i64 x, i64 lo, i64 hi) {
  return imin(imax(x, lo), hi);
}

// A lane's region: byte k read at clamp(k, 0, rw - 1).
struct Region {
  const i64* r;
  int rw;
  __device__ i64 at(i64 k) const { return ld(r + clampi(k, 0, rw - 1)); }
  // n (<= 12) bits at bit pos, MSB first (sbr_huff.read_bits)
  __device__ i64 bits(i64 pos, int n) const {
    const i64 b = pos >> 3, sh = pos & 7;
    const i64 w24 = shl(at(b), 16) | shl(at(b + 1), 8) | at(b + 2);
    return (w24 >> (24 - sh - n)) & ((1LL << n) - 1);
  }
};

struct Lut {
  const short* flat;
  const short* prefix;
  const int* bases;
  const int* maxlens;
  // the entry of table tid for the code at bit o: length in bits 0-4 (31:
  // no code), symbol index above (sbr_huff.decode_row's classification)
  __device__ i64 entry(const Region& g, i64 o, int tid) const {
    const i64 b = o >> 3, sh = o & 7;
    const i64 w32 = shl(g.at(b), 24) | shl(g.at(b + 1), 16) |
                    shl(g.at(b + 2), 8) | g.at(b + 3);
    const i64 w20 = (w32 >> (12 - sh)) & 0xFFFFF;
    const int ml = ld(maxlens + tid);
    const int pb = ml < kPrefixBits ? ml : kPrefixBits;
    const i64 e = ld(prefix + (tid << kPrefixBits) + (w20 >> (20 - pb)));
    return e >= 0 ? e : ld(flat + ld(bases + tid) + (w20 >> (20 - ml)));
  }
};

// One Huffman row (sbr_huff.decode_row): `count` codes of table tid from
// bit pos in a window of W bits.  sym(j), called for j = 0, 1, ... in
// order, gives symbol j (0 past count); p is then the bits used.
struct Row {
  const Region& g;
  const Lut& L;
  int tid;
  i64 pos, count;
  int W;
  i64 p;
  bool bad;
  __device__ Row(const Region& g_, const Lut& L_, int tid_, i64 pos_,
                 i64 count_, int W_)
      : g(g_), L(L_), tid(tid_), pos(pos_), count(count_), W(W_), p(0),
        bad(false) {}
  __device__ i64 sym(int j) {
    if (j >= count) return 0;
    if (p >= W) {  // ran past the window: the plain gather reads bit W - 1
      bad = true;
      return L.entry(g, pos + W - 1, tid) >> 5;
    }
    const i64 e = L.entry(g, pos + p, tid);
    const i64 ln = e & 31;
    if (ln == 31) {
      bad = true;
      p = W;
    } else {
      p = imin(p + ln, W);
    }
    return e >> 5;
  }
  __device__ bool ok() const { return !bad && p < W; }
};

// One channel's envelope rows (sbr_huff._env_block) into rows [5,48], and
// row `laste` into last_out unless it is null; moves pos and ok.
__device__ void env_block(const Region& g, const Lut& L, const int* lav,
                          i64& pos, bool& ok, i64 ne, i64 frbits, i64 n0,
                          i64 n1, i64 odd, const i64* df_env, i64 bal,
                          i64 ampres, bool active, const i64* carry_row,
                          i64 fr_prev, i64* rows, i64 laste, i64* last_out) {
  const i64 delta = 1 + bal;
  const int tid_t = bal > 0 ? (ampres > 0 ? T_BAL30 : T_BAL15)
                            : (ampres > 0 ? T_ENV30 : T_ENV15);
  const int tid_f = tid_t + 1;
  const i64 lav_t = ld(lav + tid_t);
  const int nbits_first = bal > 0 ? (ampres > 0 ? 5 : 6)
                                  : (ampres > 0 ? 6 : 7);
  i64 buf[2][kNB];  // the previous active row and the one being decoded
  int pb = 0;
  for (int j = 0; j < kNB; ++j) buf[0][j] = ld(carry_row + j);
  for (int e = 0; e < kE; ++e) {
    const bool act = active && e < ne;
    const i64 fr = (frbits >> e) & 1;
    const i64 nbands = fr > 0 ? n1 : n0;
    const i64 df = df_env[e];
    const bool is_dt = act && df > 0, is_df = act && df == 0;
    const i64 start = g.bits(pos, nbits_first);
    const i64 pos0 = pos + (is_df ? nbits_first : 0);
    const i64 count = is_dt ? nbands : (is_df ? imax(nbands - 1, 0) : 0);
    Row row(g, L, df > 0 ? tid_t : tid_f, pos0, count, kWEnv);
    const i64* prev = buf[pb];
    i64* cur = buf[pb ^ 1];
    i64* out = rows + e * kNB;
    i64* keep = e == laste ? last_out : nullptr;
    i64 cum = 0, last = 0;
    for (int j = 0; j < kNB; ++j) {
      const i64 s = row.sym(j);
      const i64 k = fr == fr_prev ? j
                    : fr > 0      ? (j + odd) >> 1
                    : j > 0       ? 2 * j - odd
                                  : 0;
      const bool live = j < nbands;
      if (live) cum += j == 0 ? delta * start : delta * (last - lav_t);
      i64 v = is_dt ? prev[clampi(k, 0, kNB - 1)] + delta * (s - lav_t)
                    : cum;
      v = live && act ? v : 0;
      cur[j] = v;
      out[j] = v;
      if (keep) keep[j] = v;
      last = s;
    }
    if (is_dt || is_df) ok = ok && row.ok();
    if (act) {
      pos = pos0 + row.p;
      pb ^= 1;
      fr_prev = fr;
    }
  }
}

// One channel's noise-floor rows (sbr_huff._noise_block) into rows [2,5],
// and row `lastq` into last_out unless it is null.
__device__ void noise_block(const Region& g, const Lut& L, const int* lav,
                            i64& pos, bool& ok, i64 nnoise, i64 nq,
                            const i64* df_noise, i64 bal, bool active,
                            const i64* carry_row, i64* rows, i64 lastq,
                            i64* last_out) {
  const i64 delta = 1 + bal;
  const int tid_t = bal > 0 ? T_NOISEBAL30 : T_NOISE30;
  const int tid_f = bal > 0 ? F_BAL30 : F_ENV30;
  const i64 lav_t = ld(lav + tid_t), lav_f = ld(lav + tid_f);
  i64 prev[kNQ];
#pragma unroll
  for (int j = 0; j < kNQ; ++j) prev[j] = ld(carry_row + j);
  for (int i = 0; i < 2; ++i) {
    const bool act = active && i < nnoise;
    const i64 df = df_noise[i];
    const bool is_dt = act && df > 0, is_df = act && df == 0;
    const i64 start = g.bits(pos, 5);
    const i64 pos0 = pos + (is_df ? 5 : 0);
    const i64 count = is_dt ? nq : (is_df ? imax(nq - 1, 0) : 0);
    Row row(g, L, df > 0 ? tid_t : tid_f, pos0, count, kWNoi);
    i64* out = rows + i * kNQ;
    i64* keep = i == lastq ? last_out : nullptr;
    i64 cum = 0, last = 0;
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      const i64 s = row.sym(j);
      const bool live = j < nq;
      if (live) cum += j == 0 ? delta * start : delta * (last - lav_f);
      i64 v = is_dt ? prev[j] + delta * (s - lav_t) : cum;
      v = live && act ? v : 0;
      out[j] = v;
      if (keep) keep[j] = v;
      if (act) prev[j] = v;
      last = s;
    }
    if (is_dt || is_df) ok = ok && row.ok();
    if (act) pos = pos0 + row.p;
  }
}

// `cmax` one-bit flags, those below count read while act
// (decode_sbr_rows' flag_bits).
__device__ void flag_bits(const Region& g, i64& pos, i64 count, int cmax,
                          bool act, i64* out) {
  for (int i = 0; i < cmax; ++i) {
    const bool a = act && i < count;
    out[i] = a ? g.bits(pos, 1) : 0;
    if (a) pos += 1;
  }
}

__device__ void copy_in(i64* dst, const i64* src, int n) {
  for (int j = 0; j < n; ++j) dst[j] = ld(src + j);
}

// Lane b's SBR region (sbr_huff.decode_sbr_rows).
__device__ void sbr_lane(const RowsArgs& a, const Lut& L, int b, bool pair) {
  const Region g{a.sbr_region + (i64)b * kSbrRW, kSbrRW};
  const i64 ne = ld(a.sbr_ne + b), nnoise = ld(a.sbr_nnoise + b);
  const i64 nq = ld(a.sbr_nq + b), frbits = ld(a.sbr_frbits + b);
  const i64 n0 = ld(a.sbr_n0 + b), n1 = ld(a.sbr_n1 + b);
  const i64 ampres = ld(a.sbr_ampres + b);
  const bool active = ld(a.sbr_active + b);
  const i64 coupled = pair ? ld(a.sbr_coupled + b) : 0;
  const bool cact = active && coupled > 0;
  const i64* env_last = a.sbr_env_last + (i64)b * 2 * kNB;
  const i64* noise_last = a.sbr_noise_last + (i64)b * 2 * kNQ;
  const i64* fr_last = a.sbr_fr_last + (i64)b * 2;
  i64* ecodes = a.sbr_ecodes + (i64)b * kE * kNB;
  i64* pcodes = a.sbr_pcodes + (i64)b * kE * kNB;
  i64* qcodes = a.sbr_qcodes + (i64)b * 2 * kNQ;
  i64* qpcodes = a.sbr_qpcodes + (i64)b * 2 * kNQ;
  i64* env_out = a.sbr_env_last_out + (i64)b * 2 * kNB;
  i64* noise_out = a.sbr_noise_last_out + (i64)b * 2 * kNQ;
  i64* fr_out = a.sbr_fr_last_out + (i64)b * 2;
  const i64 laste = clampi(ne - 1, 0, kE - 1);
  const i64 lastq = clampi(nnoise - 1, 0, 1);

  i64 pos = ld(a.sbr_phase + b);
  bool ok = true;
  i64 df_env0[kE], df_noi0[2], df_env1[kE], df_noi1[2];
  flag_bits(g, pos, ne, kE, active, df_env0);
  flag_bits(g, pos, nnoise, 2, active, df_noi0);
  if (pair) {
    flag_bits(g, pos, ne, kE, cact, df_env1);
    flag_bits(g, pos, nnoise, 2, cact, df_noi1);
  }
  if (active) pos += 2 * nq;  // invf modes
  // the rows carry: an active channel's last rows, else the old carry
  env_block(g, L, a.sbr_lav, pos, ok, ne, frbits, n0, n1, n1 & 1, df_env0,
            0, ampres, active, env_last, ld(fr_last), ecodes, laste,
            active ? env_out : nullptr);
  noise_block(g, L, a.sbr_lav, pos, ok, nnoise, nq, df_noi0, 0, active,
              noise_last, qcodes, lastq, active ? noise_out : nullptr);
  if (pair) {
    env_block(g, L, a.sbr_lav, pos, ok, ne, frbits, n0, n1, n1 & 1,
              df_env1, coupled, ampres, cact, env_last + kNB,
              ld(fr_last + 1), pcodes, laste,
              cact ? env_out + kNB : nullptr);
    noise_block(g, L, a.sbr_lav, pos, ok, nnoise, nq, df_noi1, coupled,
                cact, noise_last + kNQ, qpcodes, lastq,
                cact ? noise_out + kNQ : nullptr);
  } else {
    for (int j = 0; j < kE * kNB; ++j) pcodes[j] = 0;
    for (int j = 0; j < 2 * kNQ; ++j) qpcodes[j] = 0;
  }
  if (active) ok = ok && pos <= ld(a.sbr_rbits + b);
  a.sbr_ok[b] = ok;

  const i64 fr_new = (frbits >> laste) & 1;
  if (!active) {
    copy_in(env_out, env_last, kNB);
    copy_in(noise_out, noise_last, kNQ);
  }
  if (!cact) {
    copy_in(env_out + kNB, env_last + kNB, kNB);
    copy_in(noise_out + kNQ, noise_last + kNQ, kNQ);
  }
  fr_out[0] = active ? fr_new : ld(fr_last);
  fr_out[1] = cact ? fr_new : ld(fr_last + 1);
}

// The iid (icc: tabsel null) rows of decode_ps_region: four delta-coded
// rows and the zero fifth, each written once to out [5,34] with the
// fake-envelope fixup and the masks applied (decode_ps_region's fix and
// env_mask), row `last` also to carry_out; moves pos and ok.  The row a
// fixup copies (row ne_pre - 1, or the carry when ne_pre <= 0) is the
// previous active row when the fixed row is written.
__device__ void ps_kind(const Region& g, const Lut& L, const int* offsets,
                        const int* tabsel, i64& pos, bool& ok, bool en,
                        i64 iq, i64 nr, i64 ne_pre, i64 penv,
                        const i64* seed, i64* out, i64* carry_out) {
  const i64 lim = 7 + 8 * iq;
  const bool can_copy = penv > ne_pre;
  const i64 dst = clampi(ne_pre, 0, 4), last = clampi(penv - 1, 0, 4);
  i64 prev[34];
  for (int j = 0; j < 34; ++j) prev[j] = ld(seed + j);
  for (int e = 0; e < 5; ++e) {
    const bool act = e < 4 && en && e < ne_pre;
    const i64 dt = act ? g.bits(pos, 1) : 0;
    if (act) pos += 1;
    const int tid = tabsel ? ld(tabsel + 2 * dt + iq)
                           : (dt > 0 ? ICC_DT : ICC_DF);
    Row row(g, L, tid, pos, act ? nr : 0, kWRow);
    const i64 off = ld(offsets + tid);
    const bool on = e < penv && en, fixed = can_copy && e == dst;
    i64* o = out + e * 34;
    i64 cum = 0;
    bool in_range = true;
    for (int j = 0; j < 34; ++j) {
      const i64 d = row.sym(j) - off;
      cum += d;
      const bool m = j < nr && act;
      const i64 v = m ? (dt > 0 ? prev[j] + d : cum) : 0;
      in_range = in_range && !(m && (tabsel ? (v < 0 ? -v : v) > lim
                                            : v < 0 || v > 7));
      const i64 f = !on ? 0 : fixed ? (ne_pre >= 5 ? 0 : prev[j]) : v;
      o[j] = f;
      if (e == last) carry_out[j] = f;
      if (act) prev[j] = v;
    }
    ok = ok && (!act || (row.ok() && in_range));
    if (act) pos += row.p;
  }
}

// Lane b's PS region (ps_huff.decode_ps_region).
__device__ void ps_lane(const RowsArgs& a, const Lut& L, int b) {
  const Region g{a.ps_region + (i64)b * kPsRW, kPsRW};
  const i64 ne_pre = ld(a.ps_ne_pre + b), penv = ld(a.ps_penv + b);
  const i64 nipd = ld(a.ps_nipd + b);
  const i64* ipd_full = a.ps_ipd_full + (i64)b * 85;
  const i64* opd_full = a.ps_opd_full + (i64)b * 85;
  i64 pos = ld(a.ps_start_off + b);
  bool ok = true;

  ps_kind(g, L, a.ps_offsets, a.ps_iid_tabsel, pos, ok,
          ld(a.ps_enable_iid + b) > 0, ld(a.ps_iq + b), ld(a.ps_nr_iid + b),
          ne_pre, penv, a.ps_iid_last + (i64)b * 34, a.ps_iid + (i64)b * 170,
          a.ps_iid_last_out + (i64)b * 34);
  ps_kind(g, L, a.ps_offsets, nullptr, pos, ok, ld(a.ps_enable_icc + b) > 0,
          0, ld(a.ps_nr_icc + b), ne_pre, penv, a.ps_icc_last + (i64)b * 34,
          a.ps_icc + (i64)b * 170, a.ps_icc_last_out + (i64)b * 34);

  // extension container: the first id-0 extension holds ipd / opd
  const bool eact = ld(a.ps_enable_ext + b) > 0;
  const i64 cnt4 = eact ? g.bits(pos, 4) : 0;
  if (eact) pos += 4;
  const bool esc = eact && cnt4 == 15;
  const i64 cnt8 = esc ? g.bits(pos, 8) : 0;
  if (esc) pos += 8;
  const i64 cntbits = (cnt4 + cnt8) * 8;
  const i64 ext_end = pos + cntbits;
  bool found = false;
  i64 remaining = cntbits;
  for (int i = 0; i < 4; ++i) {
    const bool can = eact && !found && remaining > 7;
    const i64 id2 = can ? g.bits(pos, 2) : 3;
    if (can) {
      pos += 2;
      remaining -= 2;
    }
    found = found || (can && id2 == 0);
  }
  const i64 ipdopd_bit = found ? g.bits(pos, 1) : 0;
  if (found) pos += 1;
  const i64 pd_enable = found ? ipdopd_bit : ld(a.ps_pd_enable + b);
  const bool pd_on = pd_enable > 0;
  const bool can_copy = penv > ne_pre;
  const i64 dst = clampi(ne_pre, 0, 4);
  const i64 seed_idx = clampi(ld(a.ps_penv_prev + b) - 1, 0, 4);
  const i64* full[2] = {ipd_full, opd_full};
  i64* out[2] = {a.ps_ipd + (i64)b * 85, a.ps_opd + (i64)b * 85};
  i64* full_out[2] = {a.ps_ipd_full_out + (i64)b * 85,
                      a.ps_opd_full_out + (i64)b * 85};
  if (found && ipdopd_bit > 0) {
    // rows coded in this frame, ipd and opd interleaved; the fixup and
    // masks as in ps_kind (pd_on here)
    i64 pv[2][17];
    for (int w = 0; w < 2; ++w)
      for (int j = 0; j < 17; ++j) pv[w][j] = ld(full[w] + seed_idx * 17 + j);
    for (int e = 0; e < 5; ++e) {
      const bool on = e < penv, fixed = can_copy && e == dst;
      for (int w = 0; w < 2; ++w) {
        const bool act = e < 4 && e < ne_pre;
        const i64 dt = act ? g.bits(pos, 1) : 0;
        if (act) pos += 1;
        const int tid = dt > 0 ? (w == 0 ? IPD_DT : OPD_DT)
                               : (w == 0 ? IPD_DF : OPD_DF);
        Row row(g, L, tid, pos, act ? nipd : 0, kWPd);
        const i64 off = ld(a.ps_offsets + tid);
        i64 cum = 0;
        for (int j = 0; j < 17; ++j) {
          const i64 d = row.sym(j) - off;
          cum += d;
          const i64 v = j < nipd && act
                            ? (dt > 0 ? pv[w][j] + d : cum) & 7 : 0;
          const i64 f = !on ? 0 : fixed ? (ne_pre >= 5 ? 0 : pv[w][j]) : v;
          out[w][e * 17 + j] = full_out[w][e * 17 + j] = f;
          if (act) pv[w][j] = v;
        }
        ok = ok && (!act || row.ok());
        if (act) pos += row.p;
      }
    }
  } else {
    // the carried rows, with the fixup (its source a carried row) and
    // masks
    const i64 src = ne_pre > 0 ? clampi(ne_pre - 1, 0, 4) : seed_idx;
    for (int w = 0; w < 2; ++w)
      for (int e = 0; e < 5; ++e) {
        const bool on = e < penv && pd_on, fixed = can_copy && e == dst;
        for (int j = 0; j < 17; ++j) {
          const i64 f = !on ? 0 : ld(full[w] + (fixed ? src : e) * 17 + j);
          out[w][e * 17 + j] = f;
          full_out[w][e * 17 + j] = pd_on ? f : 0;
        }
      }
  }
  if (found) {
    pos += 1;
    ok = ok && pos <= ext_end;
  }
  if (eact) pos = imax(pos, ext_end);
  ok = ok && pos <= ld(a.ps_rbits + b);

  a.ps_pd_on[b] = pd_on;
  a.ps_pd_enable_out[b] = pd_enable;
  a.ps_ps_ok_out[b] = ok ? (ld(a.ps_header + b) > 0 ? 1 : ld(a.ps_ps_ok + b))
                         : 0;
}

__global__ void __launch_bounds__(2 * kLanes)
    qwire_rows_kernel(RowsArgs a, int B, int pair) {
  const int b = blockIdx.x * kLanes + threadIdx.x % kLanes;
  if (b >= B) return;
  if (threadIdx.x < kLanes) {
    const Lut L{a.sbr_flat, a.sbr_prefix, a.sbr_bases, a.sbr_maxlens};
    sbr_lane(a, L, b, pair != 0);
  } else {
    const Lut L{a.ps_flat, a.ps_prefix, a.ps_bases, a.ps_maxlens};
    ps_lane(a, L, b);
  }
}

}  // namespace

// Launches the kernel over B lanes on `stream`; returns the CUDA error
// code (0 when the launch was taken).
extern "C" int qwire_rows_launch(const RowsArgs* a, int B, int pair,
                                 void* stream) {
  if (B <= 0) return 0;
  qwire_rows_kernel<<<(B + kLanes - 1) / kLanes, 2 * kLanes, 0,
                      (cudaStream_t)stream>>>(*a, B, pair);
  return (int)cudaGetLastError();
}
