// The first design of kernel K1 (heaac_tpu_torch/csrc/ps_decorrelate.cu):
// one thread per (lane, parameter band) or (lane, allpass band), each
// walking its own 32-slot row with strided global loads and stores, no
// shared memory.  Same contract and same rounding as the current kernel.
// It is not part of the package: chip_smoke.py builds it only to time the
// current design against it, on the same card in the same run.

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 32;
constexpr int kParBands = 34;
constexpr float kPeakDecay = 0.76592833836465f;
constexpr float kTransientImpact = 1.5f;
constexpr float kASmooth = 0.25f;

__global__ void k1_thread_per_band_kernel(
    const float* __restrict__ power, const float* __restrict__ in_re,
    const float* __restrict__ in_im, const float* __restrict__ trans,
    const float* __restrict__ ap, const float* __restrict__ ag,
    const float* __restrict__ qf, float* __restrict__ tgain,
    float* __restrict__ ap_out, float* __restrict__ new_trans,
    float* __restrict__ new_ap, int B, int napb) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_trans = (long long)B * kParBands;
  if (t < n_trans) {
    // ---- transient detector: one (lane, parameter band) ----
    const int b = (int)(t / kParBands);
    const int i = (int)(t % kParBands);
    const float* tr = trans + ((long long)b * kParBands + i) * 3;
    float pk = tr[0], psm = tr[1], pdd = tr[2];
    const float* pw = power + ((long long)b * kParBands + i) * kSlots;
    float* tg = tgain + (long long)b * kSlots * kParBands + i;
    for (int n = 0; n < kSlots; ++n) {
      const float pn = pw[n];
      pk = fmaxf(__fmul_rn(kPeakDecay, pk), pn);
      psm = __fadd_rn(psm, __fmul_rn(kASmooth, __fsub_rn(pn, psm)));
      pdd = __fadd_rn(pdd, __fmul_rn(kASmooth,
                                     __fsub_rn(__fsub_rn(pk, pn), pdd)));
      const float denom = __fmul_rn(kTransientImpact, pdd);
      const float g = denom > psm
          ? __fdiv_rn(psm, denom != 0.0f ? denom : 1.0f) : 1.0f;
      tg[(long long)n * kParBands] = g;
    }
    float* ntr = new_trans + ((long long)b * kParBands + i) * 3;
    ntr[0] = pk;
    ntr[1] = psm;
    ntr[2] = pdd;
    return;
  }
  const long long u = t - n_trans;
  if (u >= (long long)B * napb) return;
  // ---- allpass chain: one (lane, allpass band) ----
  const int b = (int)(u / napb);
  const int k = (int)(u % napb);
  const long long bk = (long long)b * napb + k;
  float ring[3][5][2];
  const float* src = ap + bk * 30;
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      ring[m][j][0] = src[(m * 5 + j) * 2];
      ring[m][j][1] = src[(m * 5 + j) * 2 + 1];
    }
  float a[3], q0[3], q1[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    a[m] = ag[k * 3 + m];
    q0[m] = qf[(k * 3 + m) * 2];
    q1[m] = qf[(k * 3 + m) * 2 + 1];
  }
  const float* xr = in_re + bk * kSlots;
  const float* xi = in_im + bk * kSlots;
  float* out = ap_out + bk * kSlots * 2;
  for (int n = 0; n < kSlots; ++n) {
    float o_re = xr[n], o_im = xi[n];
    float st[3][2];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      // delayed sample at ring slot 5 - LINK_DELAY[m], LINK_DELAY = 3,4,5
      const float ld_re = ring[m][2 - m][0];
      const float ld_im = ring[m][2 - m][1];
      const float a_re = __fmul_rn(a[m], o_re);
      const float a_im = __fmul_rn(a[m], o_im);
      const float n_re = __fsub_rn(
          __fsub_rn(__fmul_rn(ld_re, q0[m]), __fmul_rn(ld_im, q1[m])), a_re);
      const float n_im = __fsub_rn(
          __fadd_rn(__fmul_rn(ld_re, q1[m]), __fmul_rn(ld_im, q0[m])), a_im);
      st[m][0] = __fadd_rn(o_re, __fmul_rn(a[m], n_re));
      st[m][1] = __fadd_rn(o_im, __fmul_rn(a[m], n_im));
      o_re = n_re;
      o_im = n_im;
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ring[m][j][0] = ring[m][j + 1][0];
        ring[m][j][1] = ring[m][j + 1][1];
      }
      ring[m][4][0] = st[m][0];
      ring[m][4][1] = st[m][1];
    }
    out[n * 2] = o_re;
    out[n * 2 + 1] = o_im;
  }
  float* dst = new_ap + bk * 30;
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      dst[(m * 5 + j) * 2] = ring[m][j][0];
      dst[(m * 5 + j) * 2 + 1] = ring[m][j][1];
    }
}

}  // namespace

extern "C" int k1_thread_per_band_launch(
    const float* power, const float* in_re, const float* in_im,
    const float* trans, const float* ap, const float* ag, const float* qf,
    float* tgain, float* ap_out, float* new_trans, float* new_ap, int B,
    int napb, void* stream) {
  const long long total = (long long)B * (kParBands + napb);
  if (total <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  k1_thread_per_band_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      power, in_re, in_im, trans, ap, ag, qf, tgain, ap_out, new_trans,
      new_ap, B, napb);
  return (int)cudaGetLastError();
}
