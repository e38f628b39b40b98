// Parametric-stereo transient detector + 3-link allpass chain for Hopper.
//
// Replaces the TPU kernel heaac_tpu/ops/ps_pallas.py:_kernel (entry
// decorrelate_seq) and holds its exact contract in the JAX package's
// [B, ...] layout (no lanes-minor transposes):
//   in : power [B,34,32], in_re/in_im [B,napb,32], trans [B,34,3],
//        ap [B,napb,3,5,2], ag [napb,3], qf [napb,3,2]      (all f32)
//   out: tgain [B,32,34], ap_out [B,napb,32,2], new_trans [B,34,3],
//        new_ap [B,napb,3,5,2]
// napb is 30 (20-band PS) or 50 (34-band); both take the same code.
//
// Bound.  At B=512, napb 30, the kernel reads 8,213,560 B and writes
// 8,212,480 B (16.43 MB: 4.90 us at 3.35 TB/s) for ~27 MFLOP (0.4 us at
// 67 TFLOP/s f32): bytes bound it.  The recurrences are serial only along
// the 32 QMF slots, but at ~30 f32 operations a slot per thread the
// arithmetic still takes a few microseconds of issue, so the design hides
// it under the bytes' trip in and out.  Measured on an H100 SXM (700 W,
// chip_smoke.py): cold (inputs in HBM behind a dirty L2) about 10 us,
// 49% of the bound at napb 30, and 55% at napb 50; the first design
// (one thread per row, strided loads) read 15% and 12%.  What holds the
// rest back is in PERF.md (section 5).
//
// Design.
//  - One CTA per tile of geo.lanes consecutive lanes; every input and
//    output of a tile is one contiguous run per array.  Each warp has
//    one role: threads [0, det_threads) run the transient detector, one
//    per (lane, parameter band); the rest run the allpass chain, one per
//    (lane, allpass band), with the 3x5 complex ring in registers.  The
//    slot loops are fully unrolled.  The roles never wait for each
//    other: each stages its own inputs and syncs on its own named
//    barrier.
//  - A two-step pipeline over the slots: each role issues every 16-byte
//    cp.async copy of its inputs at once, slots 0-15 of each row in one
//    group and slots 16-31 in a second, so the whole input of every
//    resident tile is in flight together (256 tiles at B=512 fit on the
//    132 SMs).  Slots 0-15 are computed while 16-31 land, and their
//    outputs are stored while 16-31 are computed.  trans, ag and qf go
//    straight to registers while the copies fly.
//  - Rows of power / in_re / in_im are staged at a pitch of 36 floats
//    and read as float4: the 8 threads of a quarter warp then hit 8
//    different 16-byte bank groups.  ap_out rows are staged at a pitch
//    of 68 floats and written as float4 every two slots, for the same
//    reason.
//  - tgain, ap_out and new_ap are staged in shared memory and stored
//    with coalesced 16-byte stores.  new_ap reuses the staged ap rows:
//    each chain thread reads its row before it writes it, and no other
//    thread touches that row.
//  - The shared-memory layout, the grid and the block come from
//    ops/ps_decorrelate.py:geometry, which the CPU tests check.
//
// Numerics.  Built with --fmad=false and without fast math, and every
// operation is written as an explicitly rounded intrinsic in the
// reference's order, so each mul and add rounds separately as in the
// reference's scan (ps_jax.py _decorrelate_scans), and psm/denom is IEEE
// division: the output is bit-identical to the plain version.

#include <cuda_runtime.h>

// Launch geometry, from ops/ps_decorrelate.py:geometry (same field order).
// Outside the anonymous namespace: the exported launcher takes it.
struct Geometry {
  int lanes;          // lanes per CTA
  int det_threads;    // threads [0, det_threads) run the detector
  int chain_threads;  // threads [det_threads, block) run the chain
  int in_pitch;       // floats per staged row of power / in_re / in_im
  int out_pitch;      // floats per staged row of ap_out
  int power, in_re, in_im, ap, tgain, ap_out;  // shared-memory byte offsets
  int smem;           // dynamic shared memory, bytes
};

namespace {

constexpr int kSlots = 32;
constexpr int kStep = 16;  // slots staged, computed and stored per step
constexpr int kSteps = kSlots / kStep;
static_assert(kSteps == 2, "cp_async_wait takes 0 or 1 groups pending");
constexpr int kParBands = 34;
constexpr int kRing = 30;  // floats per allpass band: 3 links x 5 x (re, im)
constexpr float kPeakDecay = 0.76592833836465f;
constexpr float kTransientImpact = 1.5f;
constexpr float kASmooth = 0.25f;

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}

// Waits until at most `pending` (0 or 1, a constant once the caller's
// loop is unrolled) of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// rows x `width` floats from global rows `gp` floats apart to shared rows
// `sp` floats apart (width a multiple of 4): 16 bytes a thread,
// neighbouring threads on neighbouring addresses.
template <int width>
__device__ __forceinline__ void stage(float* s, int sp, const float* g, int gp,
                                      int rows, int t, int nt) {
  constexpr int q = width / 4;
  for (int c = t; c < rows * q; c += nt)
    cp_async16(s + (c / q) * sp + (c % q) * 4, g + (c / q) * gp + (c % q) * 4);
}

// The same the other way, with 16-byte stores.
template <int width>
__device__ __forceinline__ void store(float* g, int gp, const float* s, int sp,
                                      int rows, int t, int nt) {
  constexpr int q = width / 4;
  for (int c = t; c < rows * q; c += nt)
    *reinterpret_cast<float4*>(g + (c / q) * gp + (c % q) * 4) =
        *reinterpret_cast<const float4*>(s + (c / q) * sp + (c % q) * 4);
}

// Slots [n0, n0 + kStep) of one (lane, parameter band): pw its staged
// power row, tg its column of the lane's staged tgain [32][34].
__device__ __forceinline__ void detector(const float* pw, float* tg, int n0,
                                         float& pk, float& psm, float& pdd) {
#pragma unroll
  for (int n4 = n0 / 4; n4 < (n0 + kStep) / 4; ++n4) {
    const float4 v = reinterpret_cast<const float4*>(pw)[n4];
    const float p[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float pn = p[r];
      pk = fmaxf(__fmul_rn(kPeakDecay, pk), pn);
      psm = __fadd_rn(psm, __fmul_rn(kASmooth, __fsub_rn(pn, psm)));
      pdd = __fadd_rn(pdd, __fmul_rn(kASmooth,
                                     __fsub_rn(__fsub_rn(pk, pn), pdd)));
      const float denom = __fmul_rn(kTransientImpact, pdd);
      tg[(n4 * 4 + r) * kParBands] =
          denom > psm ? __fdiv_rn(psm, denom != 0.0f ? denom : 1.0f) : 1.0f;
    }
  }
}

// Slots [n0, n0 + kStep) of one (lane, allpass band): xr/xi its staged
// input rows, out its staged ap_out row [32][2], ring its 3 links' 5-deep
// rings (ring[m][4] newest).
__device__ __forceinline__ void chain(const float* xr, const float* xi,
                                      float* out, int n0,
                                      float (&ring)[3][5][2],
                                      const float (&a)[3],
                                      const float (&q0)[3],
                                      const float (&q1)[3]) {
#pragma unroll
  for (int n4 = n0 / 4; n4 < (n0 + kStep) / 4; ++n4) {
    const float4 vr = reinterpret_cast<const float4*>(xr)[n4];
    const float4 vi = reinterpret_cast<const float4*>(xi)[n4];
    const float x_re[4] = {vr.x, vr.y, vr.z, vr.w};
    const float x_im[4] = {vi.x, vi.y, vi.z, vi.w};
    float o[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float o_re = x_re[r], o_im = x_im[r];
      float st[3][2];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        // delayed sample at ring slot 5 - LINK_DELAY[m], LINK_DELAY = 3,4,5
        const float ld_re = ring[m][2 - m][0];
        const float ld_im = ring[m][2 - m][1];
        const float a_re = __fmul_rn(a[m], o_re);
        const float a_im = __fmul_rn(a[m], o_im);
        const float n_re = __fsub_rn(
            __fsub_rn(__fmul_rn(ld_re, q0[m]), __fmul_rn(ld_im, q1[m])),
            a_re);
        const float n_im = __fsub_rn(
            __fadd_rn(__fmul_rn(ld_re, q1[m]), __fmul_rn(ld_im, q0[m])),
            a_im);
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
      o[2 * r] = o_re;
      o[2 * r + 1] = o_im;
    }
    reinterpret_cast<float4*>(out)[2 * n4] =
        make_float4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<float4*>(out)[2 * n4 + 1] =
        make_float4(o[4], o[5], o[6], o[7]);
  }
}

__global__ void __launch_bounds__(256) ps_decorrelate_kernel(
    const float* __restrict__ power, const float* __restrict__ in_re,
    const float* __restrict__ in_im, const float* __restrict__ trans,
    const float* __restrict__ ap, const float* __restrict__ ag,
    const float* __restrict__ qf, float* __restrict__ tgain,
    float* __restrict__ ap_out, float* __restrict__ new_trans,
    float* __restrict__ new_ap, int B, int napb, Geometry geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_power = reinterpret_cast<float*>(smem + geo.power);
  float* s_in_re = reinterpret_cast<float*>(smem + geo.in_re);
  float* s_in_im = reinterpret_cast<float*>(smem + geo.in_im);
  float* s_ap = reinterpret_cast<float*>(smem + geo.ap);
  float* s_tgain = reinterpret_cast<float*>(smem + geo.tgain);
  float* s_out = reinterpret_cast<float*>(smem + geo.ap_out);

  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * geo.lanes;
  const int g = (int)min((long long)geo.lanes, (long long)B - b0);
  const int ip = geo.in_pitch;

  if (t < geo.det_threads) {
    // ---- transient detector: row t = (lane t / 34, band t % 34) ----
    const int n_det = g * kParBands;
    const int nt = geo.det_threads;
    const float* pw = power + b0 * kParBands * kSlots;
    float* tg = tgain + b0 * kSlots * kParBands;
#pragma unroll
    for (int h = 0; h < kSteps; ++h) {
      stage<kStep>(s_power + h * kStep, ip, pw + h * kStep, kSlots, n_det, t,
                   nt);
      cp_async_commit();
    }
    const long long row = b0 * kParBands + t;
    float pk = 0.0f, psm = 0.0f, pdd = 0.0f;
    if (t < n_det) {
      pk = trans[row * 3];
      psm = trans[row * 3 + 1];
      pdd = trans[row * 3 + 2];
    }
    float* tg_s = s_tgain + (t / kParBands) * (kSlots * kParBands) +
                  t % kParBands;
#pragma unroll
    for (int h = 0; h < kSteps; ++h) {
      cp_async_wait(kSteps - 1 - h);
      named_sync(1, nt);  // step h's slots of every detector row landed
      if (t < n_det) detector(s_power + t * ip, tg_s, h * kStep, pk, psm, pdd);
      named_sync(1, nt);  // step h's rows of the tile's tgain are complete
      store<kStep * kParBands>(tg + h * kStep * kParBands, kSlots * kParBands,
                               s_tgain + h * kStep * kParBands,
                               kSlots * kParBands, g, t, nt);
    }
    if (t < n_det) {
      new_trans[row * 3] = pk;
      new_trans[row * 3 + 1] = psm;
      new_trans[row * 3 + 2] = pdd;
    }
  } else {
    // ---- allpass chain: row u = (lane u / napb, band u % napb) ----
    const int u = t - geo.det_threads;
    const int n_ch = g * napb;
    const int nt = geo.chain_threads;
    const float* xr = in_re + b0 * napb * kSlots;
    const float* xi = in_im + b0 * napb * kSlots;
    float* out = ap_out + b0 * napb * 2 * kSlots;
    // ap rows are 120 B, so the tile's n_ch * 30 floats go as rows of 4
    stage<4>(s_ap, 4, ap + b0 * napb * kRing, 4, n_ch * kRing / 4, u, nt);
#pragma unroll
    for (int h = 0; h < kSteps; ++h) {
      stage<kStep>(s_in_re + h * kStep, ip, xr + h * kStep, kSlots, n_ch, u,
                   nt);
      stage<kStep>(s_in_im + h * kStep, ip, xi + h * kStep, kSlots, n_ch, u,
                   nt);
      cp_async_commit();
    }
    float a[3] = {}, q0[3] = {}, q1[3] = {};
    float ring[3][5][2];
    if (u < n_ch) {
      const int k = u % napb;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        a[m] = ag[k * 3 + m];
        q0[m] = qf[(k * 3 + m) * 2];
        q1[m] = qf[(k * 3 + m) * 2 + 1];
      }
    }
    float* ring_s = s_ap + u * kRing;  // read first, then new_ap
#pragma unroll
    for (int h = 0; h < kSteps; ++h) {
      cp_async_wait(kSteps - 1 - h);
      named_sync(2, nt);  // ap and step h's slots of every input row landed
      if (u < n_ch) {
        if (h == 0) {
#pragma unroll
          for (int c = 0; c < 15; ++c) {
            const float2 v = reinterpret_cast<const float2*>(ring_s)[c];
            ring[c / 5][c % 5][0] = v.x;
            ring[c / 5][c % 5][1] = v.y;
          }
        }
        chain(s_in_re + u * ip, s_in_im + u * ip, s_out + u * geo.out_pitch,
              h * kStep, ring, a, q0, q1);
        if (h == kSteps - 1) {
#pragma unroll
          for (int c = 0; c < 15; ++c)
            reinterpret_cast<float2*>(ring_s)[c] =
                make_float2(ring[c / 5][c % 5][0], ring[c / 5][c % 5][1]);
        }
      }
      named_sync(2, nt);  // step h's slots of the tile's ap_out are complete
      store<2 * kStep>(out + h * 2 * kStep, 2 * kSlots,
                       s_out + h * 2 * kStep, geo.out_pitch, n_ch, u, nt);
    }
    store<4>(new_ap + b0 * napb * kRing, 4, s_ap, 4, n_ch * kRing / 4, u, nt);
  }
}

// Raises the kernel's dynamic shared memory limit on the current device
// to at least `smem` bytes (never lowers it).
cudaError_t allow_smem(int smem) {
  static int allowed[64] = {};  // per device: the limit set so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || smem <= allowed[dev & 63]) return err;
  err = cudaFuncSetAttribute(ps_decorrelate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) allowed[dev & 63] = smem;
  return err;
}

}  // namespace

// Launches one CTA per geo.lanes lanes (grid from the caller) on
// `stream`; returns the CUDA error code (0 when the launch was taken).
extern "C" int ps_decorrelate_launch(
    const float* power, const float* in_re, const float* in_im,
    const float* trans, const float* ap, const float* ag, const float* qf,
    float* tgain, float* ap_out, float* new_trans, float* new_ap, int B,
    int napb, int grid, Geometry geo, void* stream) {
  if (B <= 0) return 0;
  const cudaError_t err = allow_smem(geo.smem);
  if (err != cudaSuccess) return (int)err;
  ps_decorrelate_kernel<<<grid, geo.det_threads + geo.chain_threads, geo.smem,
                          (cudaStream_t)stream>>>(
      power, in_re, in_im, trans, ap, ag, qf, tgain, ap_out, new_trans,
      new_ap, B, napb, geo);
  return (int)cudaGetLastError();
}

// CTAs of the kernel one SM holds at this block and shared memory size
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
extern "C" int ps_decorrelate_ctas_per_sm(int block, int smem) {
  int n = -1;
  if (allow_smem(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, ps_decorrelate_kernel, block, smem) != cudaSuccess)
    return -1;
  return n;
}
