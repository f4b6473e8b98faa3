// K-PLL: AM carrier-synchronous detection, one chain warp per channel.
//
// Replaces the per-sample lax.scan of am_sync_detect
// (phantomsdr_tpu/ops/channelizer.py, unrolled by ops/unroll.py): per
// sample, mix the carrier and the baseband down by the NCO
// exp(-i*phase), err = arg(carrier mixed), freq += alpha*err,
// phase = mod(phase + beta*err + freq, 2*pi) with jnp.mod's sign rule
// (fmodf, then + 2*pi if negative), output = Re(baseband mixed).
//
// The phase detector as an identity: arg(c * exp(-i*phase)) =
// wrap(arg(c) - phase) into [-pi, pi].  theta = arg(c) does not depend on
// the loop, so every thread of the block computes it (libdevice's
// accurate atan2f) while the row is staged, and the step takes
// err = theta - phase, wrapped once by 2*pi: a subtraction where there
// were sincosf, a complex product and atan2f.  Its err differs from
// atan2f of the rounded product by a few 1e-7 rad, the order of the half
// ulp that the float32 phase takes at every update.  The rule, per
// sample: the identity's err, except that the mixed detector (sincosf,
// the product, atan2f, as the plain version) runs where the identity is
// not the detector in float32:
// - a carrier sample that is zero (atan2f of the product's signed zeros
//   gives 0 or +-pi) or not finite: theta holds a NaN code;
// - an err that does not land inside +-(pi - 1e-4) after its one wrap: a
//   phase outside [0, 2*pi) (a caller's phase0), or an err so near +-pi
//   that a rounding could put it on the other side;
// - a loop frequency of 0.5 rad a sample or more.  There the sums
//   freq + alpha*err and phase + freq round to a grid that alpha*err
//   cannot resolve, so any difference in err, however small, moves
//   freq by an ulp now and then, and the phase walks off by 1e-5 rad and
//   more within a few thousand samples.  No carrier the loop could hold
//   is there (the carrier filter passes 500 Hz, 0.26 rad a sample at
//   12 kHz), but noise alone is: freq walks at random without bound.
//
// Design: speculate, then verify in parallel.  One warp per channel
// runs the loop, all 32 lanes on the same values (so no lane ever waits
// for another inside it).  A round predicts the next 32 samples with the
// identity alone -- a chain of adds, multiplies and selects -- and lane j
// keeps the state before sample j.  Then every lane applies the rule to
// its own sample from that state at once: the transcendental functions
// of all the round's mixed samples take the time of one.  The first lane
// whose exact step disagrees with the prediction (bit for bit, NaN
// equal to NaN) ends the round there, with its exact state; the samples
// before it are committed.  So the result is the rule's exactly, the
// prediction decides only the speed: a row on the identity commits 32
// samples a round, a row of noise far from lock ~27 (the identity's and
// the mixed detector's updates round alike on all but ~1% of its
// samples), and a row of zeros, predicted from the quadrant of the phase
// (the signs that sincosf would give), 32.  A single thread running the
// rule instead would pace a launch by its slowest row: at 0.5 rad a
// sample and more, every sample of a noise row would wait for sincosf
// and atan2f as before.
//
// Bound: the dependent chain of the prediction, sample after sample; its
// ~16 MB of traffic at the bench shape is microseconds.  pll_chain_probe
// runs the same rounds over four samples' theta held in registers, and
// its time is the floor this kernel is measured against.
//
// Kernels:
// - pll_chain_kernel, one block per channel (channels <= SMs gives every
//   chain an SM to itself): 512 threads read the channel's carrier with
//   coalesced loads and write its theta into shared memory, then all but
//   warp 0 exit.  Warp 0 runs the rounds and stores the phase the NCO
//   used for each sample into out, 32 samples a store.  Rows longer than
//   kPiece samples run as several launches that carry phase and freq.
// - pll_output_kernel, one thread per sample: out = bb.x*cos + bb.y*sin
//   from that phase (sincosf of the same phase gives the NCO's cos and
//   sin), in place.
// The wrap: with x = phase + freq in (-2pi, 4pi) (float32 2pi),
// x >= 2pi ? x - 2pi : (x < 0 ? x + 2pi : x) equals fmodf plus the sign
// fix bit for bit (x - 2pi is exact by Sterbenz's lemma; the strict
// ends matter: fmodf gives 0 at 4pi and -0 at -2pi).  Outside that range
// the exact step calls fmodf, out of line.  The prediction subtracts
// k*2pi by fmaf, k in {-1, 0, 1} from two compares -- the same values,
// without a branch -- where the round's phase and freq keep every x
// inside that range, and otherwise k = floor(x / 2pi), found from
// floor(freq / 2pi) and one correction (a prediction: the exact step
// still decides).
// Arithmetic: round-to-nearest intrinsics (no FMA contraction) in the
// plain version's order of the loop update.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLoadThreads = 512;  // threads that stage theta
constexpr int kLoadUnroll = 4;     // carrier loads a staging thread keeps in flight
constexpr int kPiece = 16384;      // samples per chain launch (64 KB of theta)
constexpr int kWarp = 32;          // samples a round
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOutThreads = 256;
constexpr int kMaxDevices = 64;

// theta for a piece of n samples, plus the round that reads past its end
constexpr int theta_bytes(int n) {
    return static_cast<int>(sizeof(float)) * (n + kWarp);
}

// theta's codes for the samples the identity cannot take: a quiet NaN,
// for a zero sample with the sign bits of its real (bit 1) and imaginary
// (bit 0) parts below it
constexpr unsigned kNonFinite = 0x7fc00000u;
constexpr unsigned kZero = 0x7fc00004u;
// the float32 bounds of sincosf's signs on [0, 2pi): sin < 0 from pi_f
// (above pi) on; cos < 0 from pi_f/2 (above pi/2) to below 0x4096cbe4,
// the first float32 above 3pi/2
constexpr unsigned kPiBits = 0x40490fdbu;
constexpr unsigned kHalfPiBits = 0x3fc90fdbu;
constexpr unsigned kThreeHalfPiBits = 0x4096cbe4u;
// a round predicts with k0 = 0 (the two-sided wrap) while |freq| is below this
// (every x then lies inside (-2pi, 4pi): freq moves by at most 0.14 and
// beta*err by 0.14 over a round)
constexpr float kNarrowFreq = 5.5f;

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

// The prediction's wrap: x - k*2pi with k = floor(x / 2pi), given k0
// within one of k (0 where x lies in (-2pi, 4pi)); both fmaf are exact
// where their result is in [0, 2pi) (a remainder of x), and for k in
// {-1, 0, 1} the result is wrap_phase's two-sided one.  No branch: a
// select on the chain would be compiled as one, with convergence
// barriers around it.
template <bool kWide>
__device__ __forceinline__ float wrap_pred(float x, float k0, float two_pi) {
    const float r = kWide ? __fmaf_rn(-k0, two_pi, x) : x;
    const float k = k0 + (r >= two_pi ? 1.0f : 0.0f) - (r < 0.0f ? 1.0f : 0.0f);
    return __fmaf_rn(-k, two_pi, x);
}

// arg(vc), or theta's code where the step must take the mixed detector.
__device__ __forceinline__ float carrier_arg(float2 vc) {
    if (!isfinite(vc.x) || !isfinite(vc.y)) return __uint_as_float(kNonFinite);
    if (vc.x == 0.0f && vc.y == 0.0f)
        return __uint_as_float(kZero | (signbit(vc.x) ? 2u : 0u) | (signbit(vc.y) ? 1u : 0u));
    return atan2f(vc.y, vc.x);
}

__device__ __forceinline__ bool is_zero_code(float th) {
    return (__float_as_uint(th) & ~3u) == kZero;
}

// err, or on a zero code the mixed detector's err as the signs decide it:
// re and im are signed zeros, and atan2f gives +-0 or +-pi.  Exact for a
// phase in [0, 2pi) or -0; a prediction elsewhere.  In bit operations, so
// that no branch lands on the chain.
__device__ __forceinline__ float zero_or(float th, float phase, float err, float pi) {
    const unsigned code = __float_as_uint(th);
    const unsigned zero = 0u - static_cast<unsigned>((code & ~3u) == kZero);
    const unsigned sx = (code >> 1) & 1u, sy = code & 1u;
    const unsigned s = (__float_as_uint(phase) >> 31) |             // sin < 0
                       static_cast<unsigned>(phase >= __uint_as_float(kPiBits));
    const unsigned k = static_cast<unsigned>(phase >= __uint_as_float(kHalfPiBits)) &
                       static_cast<unsigned>(phase < __uint_as_float(kThreeHalfPiBits));
    const unsigned re_neg = (sx ^ k) & (sy ^ s);        // x*cs + y*sn
    const unsigned im_neg = (sy ^ k) & (sx ^ s ^ 1u);   // y*cs - x*sn
    const unsigned ez = (__float_as_uint(pi) & (0u - re_neg)) | (im_neg << 31);
    return __uint_as_float((ez & zero) | (__float_as_uint(err) & ~zero));
}

// The detector as the plain version computes it: err = arg(vc mixed down
// by exp(-i*phase)).
__device__ float mixed_err(float2 v, float phase) {
    float sn, cs;
    sincosf(phase, &sn, &cs);  // exp(-i*phase) = cs - i*sn
    const float re = __fadd_rn(__fmul_rn(v.x, cs), __fmul_rn(v.y, sn));
    const float im = __fsub_rn(__fmul_rn(v.y, cs), __fmul_rn(v.x, sn));
    return atan2f(im, re);
}

__device__ __forceinline__ bool same(float a, float b) {
    return __float_as_uint(a) == __float_as_uint(b) || (isnan(a) && isnan(b));
}

struct Loop {
    float alpha, beta, two_pi, four_pi, pi, edge, freq_edge;

    // the identity's err: theta - phase, wrapped once into [-pi, pi]
    __device__ __forceinline__ float ident_err(float th, float phase) const {
        const float e = __fsub_rn(th, phase);
        return e < -pi ? __fadd_rn(e, two_pi) : e;
    }

    // whether the rule takes the mixed detector (NaN included)
    __device__ __forceinline__ bool mixed(float ident, float freq) const {
        return !(fabsf(ident) < edge && fabsf(freq) < freq_edge);
    }

    // the loop update up to the wrap
    __device__ __forceinline__ float advance(float err, float phase, float& freq) const {
        freq = __fadd_rn(freq, __fmul_rn(alpha, err));
        return __fadd_rn(__fadd_rn(phase, __fmul_rn(beta, err)), freq);
    }
};

// theta and the carrier of a row piece: staged theta in shared memory
struct StagedRow {
    const float* theta;
    const float2* carrier;
    __device__ __forceinline__ float theta_at(int i) const { return theta[i]; }
    __device__ __forceinline__ float2 carrier_at(int i) const { return carrier[i]; }
};

// the probe's row: four samples repeated, their theta in registers
struct FourSamples {
    float t0, t1, t2, t3;
    const float2* carrier;
    int len;
    __device__ __forceinline__ float theta_at(int i) const {
        return (i & 2) ? ((i & 1) ? t3 : t2) : ((i & 1) ? t1 : t0);
    }
    __device__ __forceinline__ float2 carrier_at(int i) const { return carrier[(i & 3) % len]; }
};

// The prediction of one round: 32 samples from (phase, freq) by the
// identity (and zero_or's err on zero codes); lane j keeps the state before
// sample t + j in (bph, bf); (phase, freq) end after the 32nd.
template <bool kWide, bool kZeros, class Row>
__device__ __forceinline__ void predict(const Loop& L, const Row& row, int t, int lane,
                                        float& phase, float& freq, float& bph, float& bf) {
    const float k0 = kWide ? floorf(__fdiv_rn(freq, L.two_pi)) : 0.0f;
#pragma unroll
    for (int j = 0; j < kWarp; ++j) {
        const float th = row.theta_at(t + j);
        if (lane == j) {
            bph = phase;
            bf = freq;
        }
        float err = L.ident_err(th, phase);
        if (kZeros) err = zero_or(th, phase, err, L.pi);
        phase = wrap_pred<kWide>(L.advance(err, phase, freq), k0, L.two_pi);
    }
}

// One round over samples t .. t + min(32, left): returns how many were
// committed; (phase, freq) become the exact state after them, the same
// in every lane, and lane j < count holds sample t + j's NCO phase in nco.
template <class Row>
__device__ __forceinline__ int round_of(const Loop& L, const Row& row, int t, int left,
                                        int lane, float& phase, float& freq, float& nco) {
    const int w = left < kWarp ? left : kWarp;
    const bool live = lane < w;
    const float th = row.theta_at(t + lane);
    const bool zeros = __any_sync(kFull, live && is_zero_code(th));
    const bool narrow = !(phase < 0.0f) && !(phase >= L.two_pi) &&
                        !(fabsf(freq) >= kNarrowFreq);
    float ph = phase, f = freq, bph = phase, bf = freq;
    if (narrow) {
        if (zeros) predict<false, true>(L, row, t, lane, ph, f, bph, bf);
        else predict<false, false>(L, row, t, lane, ph, f, bph, bf);
    } else {
        if (zeros) predict<true, true>(L, row, t, lane, ph, f, bph, bf);
        else predict<true, false>(L, row, t, lane, ph, f, bph, bf);
    }
    // the predicted state after this lane's sample
    const float nph = __shfl_down_sync(kFull, bph, 1);
    const float nf = __shfl_down_sync(kFull, bf, 1);
    const float aph = lane == kWarp - 1 ? ph : nph;
    const float af = lane == kWarp - 1 ? f : nf;

    // the rule's exact step from this lane's predicted state
    float err = L.ident_err(th, bph);
    const bool mix = live && L.mixed(err, bf);
    if (__any_sync(kFull, mix) && mix) err = mixed_err(row.carrier_at(t + lane), bph);
    float qf = bf;
    const float qph = wrap_phase(L.advance(err, bph, qf), L.two_pi, L.four_pi);
    const unsigned bad =
        __ballot_sync(kFull, live && !(same(qph, aph) && same(qf, af)));
    const int count = bad ? __ffs(bad) : w;
    nco = bph;
    phase = __shfl_sync(kFull, qph, count - 1);
    freq = __shfl_sync(kFull, qf, count - 1);
    return count;
}

__global__ void __launch_bounds__(kLoadThreads)
pll_chain_kernel(const float2* __restrict__ carrier, const float* phase0,
                 const float* freq0, float* __restrict__ out, float* phase_out,
                 float* freq_out, int len, int start, int n, Loop loop) {
    extern __shared__ __align__(16) float theta[];  // samples start .. start+n, a round's pad
    const int c = blockIdx.x;
    const long long row = static_cast<long long>(c) * len + start;
    const float2* pc = carrier + row;
    for (int i0 = threadIdx.x; i0 < n; i0 += kLoadUnroll * kLoadThreads) {
        float2 v[kLoadUnroll];
#pragma unroll
        for (int k = 0; k < kLoadUnroll; ++k) {
            const int i = i0 + k * kLoadThreads;
            v[k] = i < n ? pc[i] : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int k = 0; k < kLoadUnroll; ++k) {
            const int i = i0 + k * kLoadThreads;
            if (i < n) theta[i] = carrier_arg(v[k]);
        }
    }
    if (threadIdx.x < kWarp) theta[n + threadIdx.x] = 0.0f;
    __syncthreads();
    if (threadIdx.x >= kWarp) return;

    // the rounds, warp 0 alone
    const int lane = threadIdx.x;
    float* po = out + row;
    float phase = phase0[c];
    float freq = freq0[c];
    const StagedRow src{theta, pc};
    for (int t = 0; t < n;) {
        float nco;
        const int count = round_of(loop, src, t, n - t, lane, phase, freq, nco);
        if (lane < count) po[t + lane] = nco;
        t += count;
    }
    if (lane == 0) {
        phase_out[c] = phase;
        freq_out[c] = freq;
    }
}

// out holds the NCO phase of each sample; replace it by the output.
__global__ void __launch_bounds__(kOutThreads)
pll_output_kernel(const float2* __restrict__ baseband, float* __restrict__ out,
                  long long total) {
    const long long stride = static_cast<long long>(gridDim.x) * kOutThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kOutThreads + threadIdx.x;
         i < total; i += stride) {
        float sn, cs;
        sincosf(out[i], &sn, &cs);
        const float2 v = baseband[i];
        out[i] = __fadd_rn(__fmul_rn(v.x, cs), __fmul_rn(v.y, sn));
    }
}

// The chain alone: the same rounds over the theta of four carrier
// samples held in registers (the exact step reads them from the row's
// start), no stores; one warp per channel, like pll_chain_kernel's.
__global__ void __launch_bounds__(kWarp)
pll_chain_probe(const float2* __restrict__ carrier, const float* __restrict__ phase0,
                const float* __restrict__ freq0, float* __restrict__ phase_out,
                float* __restrict__ freq_out, int len, Loop loop) {
    const int c = blockIdx.x;
    const int lane = threadIdx.x;
    float phase = phase0[c];
    float freq = freq0[c];
    if (len > 0) {
        const float2* pc = carrier + static_cast<long long>(c) * len;
        const FourSamples src{carrier_arg(pc[0]), carrier_arg(pc[1 % len]),
                              carrier_arg(pc[2 % len]), carrier_arg(pc[3 % len]), pc, len};
        for (int t = 0; t < len;) {
            float nco;
            t += round_of(loop, src, t, len - t, lane, phase, freq, nco);
        }
    }
    if (lane == 0) {
        phase_out[c] = phase;
        freq_out[c] = freq;
    }
}

Loop make_loop(float alpha, float beta, float two_pi) {
    // 2 * two_pi and two_pi / 2 are exact (power-of-two scalings)
    const float pi = 0.5f * two_pi;
    return Loop{alpha, beta, two_pi, 2.0f * two_pi, pi, pi - 1e-4f, 0.5f};
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// carrier, baseband: [channels, len] complex64; out: [channels, len]
// float32; phase0/freq0 -> phase_out/freq_out: [channels] float32.
extern "C" int pll_launch(const void* carrier, const void* baseband,
                          const float* phase0, const float* freq0, float* out,
                          float* phase_out, float* freq_out, int channels,
                          int len, float alpha, float beta, float two_pi,
                          int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Loop loop = make_loop(alpha, beta, two_pi);
    static bool opted_in[kMaxDevices] = {};  // the shared memory of a piece, once per device
    if (device >= kMaxDevices || !opted_in[device]) {
        err = cudaFuncSetAttribute(pll_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   theta_bytes(kPiece));
        if (err != cudaSuccess) {
            cudaGetLastError();  // not left for the next launcher to report
            return static_cast<int>(err);
        }
        if (device < kMaxDevices) opted_in[device] = true;
    }
    int start = 0;
    do {  // at least once, so that len == 0 still carries phase and freq
        const int n = len - start < kPiece ? len - start : kPiece;
        pll_chain_kernel<<<channels, kLoadThreads, theta_bytes(n), st>>>(
            static_cast<const float2*>(carrier), start == 0 ? phase0 : phase_out,
            start == 0 ? freq0 : freq_out, out, phase_out, freq_out, len, start, n,
            loop);
        start += n;
    } while (start < len);
    const long long total = static_cast<long long>(channels) * len;
    if (total > 0) {
        const long long blocks = (total + kOutThreads - 1) / kOutThreads;
        pll_output_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), kOutThreads,
                            0, st>>>(static_cast<const float2*>(baseband), out, total);
    }
    return static_cast<int>(cudaGetLastError());
}

// The chain floor of pll_launch's shapes: phase_out/freq_out only.
extern "C" int pll_chain_probe_launch(const void* carrier, const float* phase0,
                                      const float* freq0, float* phase_out,
                                      float* freq_out, int channels, int len,
                                      float alpha, float beta, float two_pi,
                                      int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    pll_chain_probe<<<channels, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(carrier), phase0, freq0, phase_out, freq_out, len,
        make_loop(alpha, beta, two_pi));
    return static_cast<int>(cudaGetLastError());
}
