// K-ANR: block LMS noise reduction / auto-notch, one chain per channel.
//
// Replaces the lax.scan over _block_body in anr_process
// (phantomsdr_tpu/ops/anr.py), the block reformulation of wdsp's
// variable-leak LMS (jsdsp/lib/ANR.c).  Per channel the step's samples
// run in blocks of bsz (the last block len mod bsz); per block, with
// seg = the taps+delay-1 history samples (oldest first) ++ the block:
//   y_n     = sum_j w_j seg[taps-1-j+n]        (block-start weights)
//   sigma_n = sum_j seg[taps-1-j+n]^2, inv_n = 1 / (sigma_n + 1e-10)
//   e_n     = x_n - y_n, out_n = e_n (notch) or 4 y_n
//   nel_n   = |e_n (1 - two_mu sigma_n inv_n)|
//   nev_n   = |x_n - (1 - two_mu ngamma) y_n - two_mu e_n sigma_n inv_n|
//   lidx    = 120 if any nev_n < nel_n, ngamma = gamma lidx^4 6.25e-10
//   w_t     = lam^bsz w_t + sum_n (two_mu e_n inv_n) seg[taps-1-t+n],
//             lam = 1 - two_mu ngamma, lam^bsz by binary exponentiation
//             (JAX's integer_pow)
// and the carries come back in JAX's layout (hist newest first).
//
// Bound: operations, three taps-long products a sample (0.32 GFLOP at
// the bench shape, 128 channels x 6480 samples, taps 64).  The blocks of
// a channel are a dependent chain: a block's prediction needs the
// weights the one before it produced.
//
// Design: one block of 256 threads per channel keeps the chain's state
// in shared memory: seg, the weights, the per-sample update factors c1
// and the partial sums of the update.  Per LMS block: each thread
// predicts its samples (w_j is a broadcast, seg[taps-1-j+n] runs along
// the threads, so neither read conflicts), writes its output and c1_n,
// and the block ORs the leak triggers with __syncthreads_or; then
// 256/taps groups of taps threads each sum a contiguous part of the
// samples for every tap, and taps threads add the parts in order and
// update the weights; last the history slides.  anr_chain_probe runs
// the same chain with the block staged once, without the global loads
// and the output stores, as the floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStaticSmem = 48 * 1024;

struct Args {
    const float* x;
    const float* hist0;
    const float* w0;
    const float* lidx0;
    const float* ngamma0;
    float* out;
    float* hist1;
    float* w1;
    float* lidx1;
    float* ngamma1;
    int len, taps, delay, bsz, notch;
    float two_mu, gamma;
};

__device__ __forceinline__ float leak(float gamma, float lidx) {
    const float l2 = __fmul_rn(lidx, lidx);
    return __fmul_rn(__fmul_rn(__fmul_rn(gamma, l2), l2), 6.25e-10f);
}

// x^n for n >= 1, in the order of JAX's integer_pow lowering
__device__ __forceinline__ float int_pow(float x, int n) {
    float acc = 1.0f;
    bool have = false;
    while (n > 0) {
        if (n & 1) {
            acc = have ? __fmul_rn(acc, x) : x;
            have = true;
        }
        n >>= 1;
        if (n > 0) x = __fmul_rn(x, x);
    }
    return acc;
}

template <bool kProbe>
__global__ void __launch_bounds__(kThreads) anr_kernel(Args a) {
    extern __shared__ float smem[];
    const int taps = a.taps;
    const int lkeep = taps + a.delay - 1;
    const int parts = taps < kThreads ? kThreads / taps : 1;
    float* seg = smem;                       // [lkeep + bsz]
    float* tmp = seg + lkeep + a.bsz;        // [lkeep]
    float* w = tmp + lkeep;                  // [taps]
    float* c1 = w + taps;                    // [bsz]
    float* part = c1 + a.bsz;                // [parts * taps]
    const int c = blockIdx.x;
    const long long row = static_cast<long long>(c) * a.len;
    const int tid = threadIdx.x;
    const int hl = taps + a.delay;
    for (int i = tid; i < lkeep; i += kThreads) seg[i] = a.hist0[c * hl + lkeep - 1 - i];
    for (int j = tid; j < taps; j += kThreads) w[j] = a.w0[c * taps + j];
    float lidx = a.lidx0[c];
    float ngamma = a.ngamma0[c];
    const float two_mu = a.two_mu;
    int n_last = 0;  // samples in the last block run
    for (int s = 0; s < a.len; s += a.bsz) {
        const int nb = a.len - s < a.bsz ? a.len - s : a.bsz;
        n_last = nb;
        if (!kProbe || s == 0)
            for (int n = tid; n < nb; n += kThreads) seg[lkeep + n] = a.x[row + s + n];
        __syncthreads();
        // 1. predictions, outputs, update factors, leak triggers
        const float keep_y = __fsub_rn(1.0f, __fmul_rn(two_mu, ngamma));
        int trig = 0;
        for (int n = tid; n < nb; n += kThreads) {
            float y = 0.0f, sigma = 0.0f;
            const float* sp = seg + taps - 1 + n;
            for (int j = 0; j < taps; ++j) {
                const float v = sp[-j];
                y = fmaf(w[j], v, y);
                sigma = fmaf(v, v, sigma);
            }
            const float xn = seg[lkeep + n];
            const float inv = __fdiv_rn(1.0f, __fadd_rn(sigma, 1e-10f));
            const float err = __fsub_rn(xn, y);
            if (!kProbe) a.out[row + s + n] = a.notch ? err : __fmul_rn(4.0f, y);
            const float ts = __fmul_rn(__fmul_rn(two_mu, sigma), inv);
            const float nel = fabsf(__fmul_rn(err, __fsub_rn(1.0f, ts)));
            const float nev = fabsf(__fsub_rn(
                __fsub_rn(xn, __fmul_rn(keep_y, y)),
                __fmul_rn(__fmul_rn(__fmul_rn(two_mu, err), sigma), inv)));
            trig |= nev < nel;
            c1[n] = __fmul_rn(__fmul_rn(two_mu, err), inv);
        }
        if (__syncthreads_or(trig)) lidx = 120.0f;
        ngamma = leak(a.gamma, lidx);
        // 2. the update, in parts of contiguous samples per tap
        const int chunk = (nb + parts - 1) / parts;
        for (int k = tid; k < parts * taps; k += kThreads) {
            const int p = k / taps, t = k - p * taps;
            const int n0 = p * chunk;
            const int n1 = n0 + chunk < nb ? n0 + chunk : nb;
            float g = 0.0f;
            const float* sp = seg + taps - 1 - t;
            for (int n = n0; n < n1; ++n) g = fmaf(c1[n], sp[n], g);
            part[k] = g;
        }
        __syncthreads();
        const float lam_b = int_pow(__fsub_rn(1.0f, __fmul_rn(two_mu, ngamma)), nb);
        for (int t = tid; t < taps; t += kThreads) {
            float g = part[t];
            for (int p = 1; p < parts; ++p) g = __fadd_rn(g, part[p * taps + t]);
            w[t] = __fadd_rn(__fmul_rn(lam_b, w[t]), g);
        }
        // 3. slide the history: the last lkeep samples of seg
        if (s + nb < a.len) {
            for (int i = tid; i < lkeep; i += kThreads) tmp[i] = seg[nb + i];
            __syncthreads();
            for (int i = tid; i < lkeep; i += kThreads) seg[i] = tmp[i];
        }
        __syncthreads();
    }
    // carries: the newest taps+delay samples of the last seg, newest first
    const int seg_len = lkeep + n_last;
    for (int k = tid; k < hl; k += kThreads) {
        if (a.len > 0)
            a.hist1[c * hl + k] = seg[seg_len - 1 - k];
        else
            a.hist1[c * hl + k] = a.hist0[c * hl + k];
    }
    for (int t = tid; t < taps; t += kThreads) a.w1[c * taps + t] = w[t];
    if (tid == 0) {
        a.lidx1[c] = lidx;
        a.ngamma1[c] = ngamma;
    }
}

size_t smem_bytes(int taps, int delay, int bsz) {
    const int lkeep = taps + delay - 1;
    const int parts = taps < kThreads ? kThreads / taps : 1;
    return sizeof(float) * (2 * static_cast<size_t>(lkeep) + 2 * bsz + taps +
                            static_cast<size_t>(parts) * taps);
}

template <bool kProbe>
int launch(const Args& a, int channels, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (channels == 0) return 0;
    if (a.taps < 1 || a.delay < 1 || a.bsz < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(a.taps, a.delay, a.bsz);
    if (smem > kMaxStaticSmem) return static_cast<int>(cudaErrorInvalidValue);
    anr_kernel<kProbe><<<channels, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* x, const float* hist0, const float* w0, const float* lidx0,
               const float* ngamma0, float* out, float* hist1, float* w1, float* lidx1,
               float* ngamma1, int len, int taps, int delay, int bsz, int notch, float two_mu,
               float gamma) {
    return Args{x,   hist0, w0,    lidx0, ngamma0, out,   hist1,  w1,   lidx1,
                ngamma1, len, taps, delay, bsz, notch, two_mu, gamma};
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: [channels, len] float32; hist0/hist1: [channels, taps+delay];
// w0/w1: [channels, taps]; lidx/ngamma: [channels].
extern "C" int anr_launch(const float* x, const float* hist0, const float* w0,
                          const float* lidx0, const float* ngamma0, float* out, float* hist1,
                          float* w1, float* lidx1, float* ngamma1, int channels, int len,
                          int taps, int delay, int bsz, int notch, float two_mu, float gamma,
                          int device, void* stream) {
    return launch<false>(make_args(x, hist0, w0, lidx0, ngamma0, out, hist1, w1, lidx1, ngamma1,
                                   len, taps, delay, bsz, notch, two_mu, gamma),
                         channels, device, stream);
}

extern "C" int anr_chain_probe_launch(const float* x, const float* hist0, const float* w0,
                                      const float* lidx0, const float* ngamma0, float* out,
                                      float* hist1, float* w1, float* lidx1, float* ngamma1,
                                      int channels, int len, int taps, int delay, int bsz,
                                      int notch, float two_mu, float gamma, int device,
                                      void* stream) {
    return launch<true>(make_args(x, hist0, w0, lidx0, ngamma0, out, hist1, w1, lidx1, ngamma1,
                                  len, taps, delay, bsz, notch, two_mu, gamma),
                        channels, device, stream);
}
