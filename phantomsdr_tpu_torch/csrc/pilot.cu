// K-PILOT: the 19 kHz pilot PLL of WBFM stereo and RDS, one chain
// thread per channel, and the subcarrier mixes that use its phase.
//
// Replaces the per-sample lax.scan of pilot_track
// (phantomsdr_tpu/ops/stereo.py, unrolled by ops/unroll.py) and the
// mixes after it (stereo_demix there, the 57 kHz downmix of
// rds_from_pilot in phantomsdr_tpu/ops/rds.py).  Per channel and sample
// of the bandpassed pilot y:
//
//   e     = (-2 * y) * sin(phase)
//   freq  = freq + alpha * e
//   ph    = phase + beta * e                  (the mixers' phase)
//   phase = mod((ph + f_nom) + freq, 2*pi)    (jnp.mod: fmodf, then
//                                              + 2*pi if negative)
//
// then, from ph and the group-delayed MPX:
//   stereo (FM rows; others pass mono): lr = (2 * xs) * cos(2 * ph),
//          L = xs + lr * m, R = xs - lr * m   (m = 1 on FM rows, else 0)
//   RDS:   I = (2 * xr) * cos(3 * ph), Q = (-2 * xr) * sin(3 * ph)
// L/R go to rows 2c, 2c+1 of a [2C, len] buffer (the per-stream rows
// de-emphasis and decimation read), I/Q likewise (the rows the RDS
// lowpass reads).
//
// Bound: the dependent chain, one sine and six rounded float32
// operations and the wrap per sample; its bytes (the pilot in, L/R and
// I/Q out) are microseconds.  pilot_chain_probe runs the same loop over
// a pilot held in registers (no loads, no stores), and its time is the
// floor this kernel is measured against; with the earlier design's loop
// body (kEarlier) it gives the floor before this design.
//
// Design: one chain thread per channel, alone in its warp (see
// csrc/pll.cu), on a chain made as short as the results allow:
// - The sine is wrapped_sin (csrc/wrapped_sin.cuh): libdevice sinf's
//   fast path for [0, 2*pi], bit for bit, without the Payne-Hanek branch
//   and its stack frame.  The wrap guarantees that range: each step's
//   sine is taken of the wrapped phase at the end of the step, and only
//   phase0, which the caller may give outside it, goes through sinf,
//   once, before the loop.
// - The wrap is K-PLL's: with x = (ph + f_nom) + freq in (-2pi, 4pi),
//   x >= 2pi ? x - 2pi : (x < 0 ? x + 2pi : x) equals fmodf plus the sign
//   fix bit for bit; the selects run unconditionally and a branch that
//   resolves beside them sends x outside that range to fmodf, out of line
//   (its result lies in [0, 2pi] too, or is a NaN, which wrapped_sin
//   keeps).
// - pilot_chain_kernel, one launch for the whole row: a block of one
//   warp per channel whose lane 0 runs the chain and the others exit.  It
//   reads the pilot from global memory (L2: the FIR that made it ran just
//   before) through a ring of kAhead groups of four samples in registers,
//   each group loaded seven groups (~2,400 cycles) before its use, and
//   stores each sample's ph.  Nothing else shares the block: helper warps
//   that staged the pilot in shared memory behind flags made the compiler
//   bracket each step's rare branch with convergence barriers (BSSY/
//   BSYNC), and the chain ran slower (tools/torch_kernel_breakdown.py
//   reports the barriers of each function, and the kernel's time with
//   other ring depths: shallower rings wait on the loads, deeper ones
//   outgrow the instruction cache).
// - pilot_mix_kernel, one thread per sample, then forms the outputs from
//   ph.
// Round-to-nearest intrinsics keep the plain version's operation order.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "wrapped_sin.cuh"

namespace {

constexpr int kAhead = 8;  // groups of four pilot samples the chain holds in registers
constexpr int kMixThreads = 256;

// The loop bodies: the kernel's, and the earlier design's (libdevice
// sinf of the phase at the step's start, the wrap as a branch), which
// only the probe runs, for the floor the kernel's body is compared with.
enum Body { kWrapped = 0, kEarlier = 1 };

__device__ __noinline__ float wrap_fmod(float x, float two_pi) {
    const float r = fmodf(x, two_pi);
    return r < 0.0f ? __fadd_rn(r, two_pi) : r;
}

__device__ __forceinline__ float wrap_phase(float x, float two_pi, float four_pi) {
    if (x > -two_pi && x < four_pi)
        return x >= two_pi ? __fsub_rn(x, two_pi)
                           : (x < 0.0f ? __fadd_rn(x, two_pi) : x);
    return wrap_fmod(x, two_pi);
}

// Four samples of a row from t on (t + 4 <= len).  Scalar loads and
// stores: any row length (16-byte ones were no faster on aligned rows).
__device__ __forceinline__ float4 load_group(const float* __restrict__ p, int t) {
    return make_float4(__ldg(p + t), __ldg(p + t + 1), __ldg(p + t + 2), __ldg(p + t + 3));
}

__device__ __forceinline__ void store_group(float* __restrict__ p, int t, float4 v) {
    p[t] = v.x;
    p[t + 1] = v.y;
    p[t + 2] = v.z;
    p[t + 3] = v.w;
}

struct Loop {
    float alpha, beta, f_nom, two_pi, four_pi;

    // One sample of pilot y: advance phase and freq, return ph; s is
    // sin(phase), carried to the next step (kEarlier takes the sine of
    // phase itself and leaves s alone).
    template <int kBody>
    __device__ __forceinline__ float step(float y, float& phase, float& freq,
                                          float& s) const {
        const float e = __fmul_rn(__fmul_rn(-2.0f, y), kBody == kEarlier ? sinf(phase) : s);
        freq = __fadd_rn(freq, __fmul_rn(alpha, e));
        const float ph = __fadd_rn(phase, __fmul_rn(beta, e));
        const float x = __fadd_rn(__fadd_rn(ph, f_nom), freq);
        if (kBody == kEarlier) {
            phase = wrap_phase(x, two_pi, four_pi);
            return ph;
        }
        const float hi = __fsub_rn(x, two_pi);
        const float lo = __fadd_rn(x, two_pi);
        phase = x >= two_pi ? hi : (x < 0.0f ? lo : x);
        if (!(x > -two_pi && x < four_pi))  // rare: fmodf, out of line
            phase = wrap_fmod(x, two_pi);
        s = wrapped_sin(phase);
        return ph;
    }

    template <int kBody>
    __device__ __forceinline__ float4 step4(float4 y, float& phase, float& freq,
                                            float& s) const {
        float4 ph;
        ph.x = step<kBody>(y.x, phase, freq, s);
        ph.y = step<kBody>(y.y, phase, freq, s);
        ph.z = step<kBody>(y.z, phase, freq, s);
        ph.w = step<kBody>(y.w, phase, freq, s);
        return ph;
    }
};

// One thread per channel, alone in its block's warp.
__global__ void __launch_bounds__(32)
pilot_chain_kernel(const float* __restrict__ pilot, const float* __restrict__ phase0,
                   const float* __restrict__ freq0, float* __restrict__ ph,
                   float* __restrict__ phase_out, float* __restrict__ freq_out, int len,
                   Loop loop) {
    if (threadIdx.x != 0) return;
    const int c = blockIdx.x;
    const long long row = static_cast<long long>(c) * len;
    const float* pc = pilot + row;
    float* po = ph + row;
    float phase = phase0[c];
    float freq = freq0[c];
    float s = sinf(phase);  // phase0 may lie anywhere
    int t = 0;
    if (len >= 4 * kAhead) {
        // a ring of kAhead groups in registers (fully unrolled, so its
        // indices are static), each loaded kAhead - 1 groups before its
        // use; loads past the row's last whole group read that group
        // again (not used)
        const int last = (len & ~3) - 4;
        float4 q[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead - 1; ++k) q[k] = load_group(pc, 4 * k);
        for (; t + 4 * kAhead <= len; t += 4 * kAhead) {
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
                q[(k + kAhead - 1) % kAhead] =
                    load_group(pc, min(t + 4 * (k + kAhead - 1), last));
                store_group(po, t + 4 * k, loop.step4<kWrapped>(q[k], phase, freq, s));
            }
        }
#pragma unroll
        for (int k = 0; k < kAhead - 1; ++k) {
            if (t + 4 <= len) {
                store_group(po, t, loop.step4<kWrapped>(q[k], phase, freq, s));
                t += 4;
            }
        }
    }
    for (; t < len; ++t) po[t] = loop.step<kWrapped>(pc[t], phase, freq, s);
    phase_out[c] = phase;
    freq_out[c] = freq;
}

// grid (ceil(len / kMixThreads), channels)
__global__ void __launch_bounds__(kMixThreads)
pilot_mix_kernel(const float* __restrict__ ph, const float* __restrict__ xs,
                 const uint8_t* __restrict__ fm, float* __restrict__ lr,
                 const float* __restrict__ xr, float* __restrict__ iq, int len) {
    const int t = blockIdx.x * kMixThreads + threadIdx.x;
    if (t >= len) return;
    const int c = blockIdx.y;
    const long long i = static_cast<long long>(c) * len + t;
    const long long even = static_cast<long long>(2 * c) * len + t;
    const float p = ph[i];
    if (xs != nullptr) {
        const float x = xs[i];
        const float m = fm[c] ? 1.0f : 0.0f;
        const float d = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, x), cosf(__fmul_rn(2.0f, p))), m);
        lr[even] = __fadd_rn(x, d);
        lr[even + len] = __fsub_rn(x, d);
    }
    if (xr != nullptr) {
        const float x = xr[i];
        const float p3 = __fmul_rn(3.0f, p);
        iq[even] = __fmul_rn(__fmul_rn(2.0f, x), cosf(p3));
        iq[even + len] = __fmul_rn(__fmul_rn(-2.0f, x), sinf(p3));
    }
}

// The chain alone: the same four-sample groups over four pilot samples
// held in registers, no loads or stores inside the loop; one thread per
// channel, alone like pilot_chain_kernel's.  kBody picks the loop body.
template <int kBody>
__global__ void __launch_bounds__(32)
pilot_chain_probe(const float* __restrict__ pilot, const float* __restrict__ phase0,
                  const float* __restrict__ freq0, float* __restrict__ phase_out,
                  float* __restrict__ freq_out, int len, Loop loop) {
    if (threadIdx.x != 0) return;
    const int c = blockIdx.x;
    float phase = phase0[c];
    float freq = freq0[c];
    float s = kBody == kEarlier ? 0.0f : sinf(phase);  // kEarlier has no carried sine
    if (len > 0) {
        const float* pc = pilot + static_cast<long long>(c) * len;
        const float4 y = make_float4(pc[0], pc[1 % len], pc[2 % len], pc[3 % len]);
        int t = 0;
        for (; t + 4 <= len; t += 4) loop.step4<kBody>(y, phase, freq, s);
        for (; t < len; ++t) loop.step<kBody>(y.x, phase, freq, s);
    }
    phase_out[c] = phase;
    freq_out[c] = freq;
}

// Every float32 in [-0, two_pi]: count where wrapped_sin and sinf differ
// in any bit.  count[0] += values checked, count[1] += mismatches.
__global__ void __launch_bounds__(256)
pilot_sin_check(unsigned top, unsigned long long* count) {
    unsigned long long checked = 0, differ = 0;
    const unsigned stride = gridDim.x * blockDim.x;
    for (unsigned long long b = blockIdx.x * blockDim.x + threadIdx.x; b <= top + 1ULL;
         b += stride) {
        // bits 0 .. top, then -0
        const float a = __uint_as_float(b <= top ? static_cast<unsigned>(b) : 0x80000000u);
        differ += __float_as_uint(wrapped_sin(a)) != __float_as_uint(sinf(a));
        ++checked;
    }
    for (int o = 16; o > 0; o /= 2) {
        checked += __shfl_xor_sync(0xffffffffu, checked, o);
        differ += __shfl_xor_sync(0xffffffffu, differ, o);
    }
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(count, checked);
        atomicAdd(count + 1, differ);
    }
}

Loop make_loop(float alpha, float beta, float f_nom, float two_pi) {
    // 2 * two_pi is exact (a power-of-two scaling)
    return Loop{alpha, beta, f_nom, two_pi, 2.0f * two_pi};
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pilot, ph: [channels, len] float32; phase0/freq0 -> phase_out/freq_out:
// [channels] float32.  xs (with fm [channels] bool and lr [2*channels,
// len]) and xr (with iq [2*channels, len]) are each null or [channels,
// len] float32: the stereo and RDS mixes are formed only where given.
extern "C" int pilot_launch(const float* pilot, const float* phase0, const float* freq0,
                            float* ph, float* phase_out, float* freq_out,
                            const float* xs, const uint8_t* fm, float* lr,
                            const float* xr, float* iq, int channels, int len,
                            float alpha, float beta, float f_nom, float two_pi,
                            int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Loop loop = make_loop(alpha, beta, f_nom, two_pi);
    pilot_chain_kernel<<<channels, 32, 0, st>>>(pilot, phase0, freq0, ph, phase_out, freq_out,
                                                len, loop);
    if (len > 0 && (xs != nullptr || xr != nullptr)) {
        const dim3 grid((len + kMixThreads - 1) / kMixThreads, channels);
        pilot_mix_kernel<<<grid, kMixThreads, 0, st>>>(ph, xs, fm, lr, xr, iq, len);
    }
    return static_cast<int>(cudaGetLastError());
}

// The chain floor of pilot_launch's shapes: phase_out (and freq_out)
// only.  body: 0 the kernel's loop, 1 the earlier design's.
extern "C" int pilot_chain_probe_launch(const float* pilot, const float* phase0,
                                        const float* freq0, float* phase_out,
                                        float* freq_out, int channels, int len,
                                        float alpha, float beta, float f_nom,
                                        float two_pi, int body, int device,
                                        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Loop loop = make_loop(alpha, beta, f_nom, two_pi);
    if (body == kWrapped)
        pilot_chain_probe<kWrapped><<<channels, 32, 0, st>>>(pilot, phase0, freq0, phase_out,
                                                             freq_out, len, loop);
    else if (body == kEarlier)
        pilot_chain_probe<kEarlier><<<channels, 32, 0, st>>>(pilot, phase0, freq0, phase_out,
                                                             freq_out, len, loop);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

// wrapped_sin against sinf on every float32 in [-0, two_pi]: count[0]
// (zeroed by the caller) receives the values checked, count[1] the
// mismatches.
extern "C" int pilot_sin_check_launch(unsigned long long* count, float two_pi, int device,
                                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    unsigned top;
    memcpy(&top, &two_pi, sizeof(top));
    pilot_sin_check<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(top, count);
    return static_cast<int>(cudaGetLastError());
}
