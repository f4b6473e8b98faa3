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
// Bound: the dependent chain, one accurate sinf and six rounded float32
// operations and the wrap per sample; its bytes (the pilot in, L/R and
// I/Q out) are microseconds.  pilot_chain_probe runs the same loop over
// a pilot held in registers (no loads, no stores), and its time is the
// floor this kernel is measured against.
//
// Design: K-PLL's (csrc/pll.cu).  pilot_chain_kernel, one block per
// channel: 128 threads copy the channel's pilot into shared memory
// (kPiece samples a launch; longer rows run as several launches that
// carry phase and freq), then all but thread 0 exit, so that the chain
// has no lane to reconverge with, and thread 0 runs it, reading the
// pilot four samples at a time and storing each sample's ph.
// pilot_mix_kernel, one thread per sample, then forms the outputs from
// ph.  The wrap is K-PLL's: one subtract or add of 2*pi where that
// equals fmodf plus the sign fix bit for bit, fmodf elsewhere.
// Round-to-nearest intrinsics keep the plain version's operation order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLoadThreads = 128;  // threads that stage the pilot
constexpr int kPiece = 32768;      // samples per chain launch (128 KB of pilot)
constexpr int kMixThreads = 256;
constexpr int kMaxDevices = 64;

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

struct Loop {
    float alpha, beta, f_nom, two_pi, four_pi;

    // One sample of pilot y: advance phase and freq, return ph.
    __device__ __forceinline__ float step(float y, float& phase, float& freq) const {
        const float e = __fmul_rn(__fmul_rn(-2.0f, y), sinf(phase));
        freq = __fadd_rn(freq, __fmul_rn(alpha, e));
        const float ph = __fadd_rn(phase, __fmul_rn(beta, e));
        phase = wrap_phase(__fadd_rn(__fadd_rn(ph, f_nom), freq), two_pi, four_pi);
        return ph;
    }

    __device__ __forceinline__ float4 step4(float4 y, float& phase, float& freq) const {
        float4 ph;
        ph.x = step(y.x, phase, freq);
        ph.y = step(y.y, phase, freq);
        ph.z = step(y.z, phase, freq);
        ph.w = step(y.w, phase, freq);
        return ph;
    }
};

__global__ void __launch_bounds__(kLoadThreads)
pilot_chain_kernel(const float* __restrict__ pilot, const float* phase0,
                   const float* freq0, float* __restrict__ ph, float* phase_out,
                   float* freq_out, int len, int start, int n, Loop loop) {
    extern __shared__ __align__(16) float yp[];  // samples start .. start+n
    const int c = blockIdx.x;
    const long long row = static_cast<long long>(c) * len + start;
    const float* pc = pilot + row;
    for (int i = threadIdx.x; i < n; i += kLoadThreads) yp[i] = pc[i];
    __syncthreads();
    if (threadIdx.x != 0) return;

    // the chain, alone
    float* po = ph + row;
    float phase = phase0[c];
    float freq = freq0[c];
    const float4* y4 = reinterpret_cast<const float4*>(yp);
    int t = 0;
    for (; t + 4 <= n; t += 4) {
        const float4 v = loop.step4(y4[t / 4], phase, freq);
        po[t] = v.x;
        po[t + 1] = v.y;
        po[t + 2] = v.z;
        po[t + 3] = v.w;
    }
    for (; t < n; ++t) po[t] = loop.step(yp[t], phase, freq);
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
// channel, alone like pilot_chain_kernel's.
__global__ void __launch_bounds__(32)
pilot_chain_probe(const float* __restrict__ pilot, const float* __restrict__ phase0,
                  const float* __restrict__ freq0, float* __restrict__ phase_out,
                  float* __restrict__ freq_out, int len, Loop loop) {
    if (threadIdx.x != 0) return;
    const int c = blockIdx.x;
    float phase = phase0[c];
    float freq = freq0[c];
    if (len > 0) {
        const float* pc = pilot + static_cast<long long>(c) * len;
        const float4 y = make_float4(pc[0], pc[1 % len], pc[2 % len], pc[3 % len]);
        int t = 0;
        for (; t + 4 <= len; t += 4) loop.step4(y, phase, freq);
        for (; t < len; ++t) loop.step(y.x, phase, freq);
    }
    phase_out[c] = phase;
    freq_out[c] = freq;
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
    static bool opted_in[kMaxDevices] = {};  // the shared memory of a piece, once per device
    if (device >= kMaxDevices || !opted_in[device]) {
        err = cudaFuncSetAttribute(pilot_chain_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(sizeof(float)) * kPiece);
        if (err != cudaSuccess) {
            cudaGetLastError();  // not left for the next launcher to report
            return static_cast<int>(err);
        }
        if (device < kMaxDevices) opted_in[device] = true;
    }
    int start = 0;
    do {  // at least once, so that len == 0 still carries phase and freq
        const int n = len - start < kPiece ? len - start : kPiece;
        pilot_chain_kernel<<<channels, kLoadThreads, sizeof(float) * n, st>>>(
            pilot, start == 0 ? phase0 : phase_out, start == 0 ? freq0 : freq_out, ph,
            phase_out, freq_out, len, start, n, loop);
        start += n;
    } while (start < len);
    if (len > 0 && (xs != nullptr || xr != nullptr)) {
        const dim3 grid((len + kMixThreads - 1) / kMixThreads, channels);
        pilot_mix_kernel<<<grid, kMixThreads, 0, st>>>(ph, xs, fm, lr, xr, iq, len);
    }
    return static_cast<int>(cudaGetLastError());
}

// The chain floor of pilot_launch's shapes: phase_out (and freq_out) only.
extern "C" int pilot_chain_probe_launch(const float* pilot, const float* phase0,
                                        const float* freq0, float* phase_out,
                                        float* freq_out, int channels, int len,
                                        float alpha, float beta, float f_nom,
                                        float two_pi, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    pilot_chain_probe<<<channels, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        pilot, phase0, freq0, phase_out, freq_out, len,
        make_loop(alpha, beta, f_nom, two_pi));
    return static_cast<int>(cudaGetLastError());
}
