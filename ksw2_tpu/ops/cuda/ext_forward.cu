// Batched anti-diagonal extension DP for Hopper, called from JAX through
// the XLA FFI (target "ksw2_ext_forward").
//
// One thread block aligns one pair.  The block walks the anti-diagonals
// r = 0 .. qlen+tlen-2 in order; on each, its threads take the band's
// lanes t in [st, en] (16-rounded like the reference's SSE blocks) in
// strides of the block size.  The difference planes u, v, x, y (and
// x2, y2 for the two-piece model) are int8 and wrap like the SSE bytes;
// they are double-buffered by the parity of r, so a lane reads lane t-1
// of the previous diagonal without a barrier.  Because the rounded band
// only slides forward, every lane read on diagonal r was written on r-1
// or never.  The score profile s and the 32-bit H row are single arrays
// with the reference's stale-lane semantics.  Planes live in shared
// memory when they fit, else in a global scratch result.
//
// Each diagonal ends with a block reduction of the exact-max (H, key)
// pairs, then thread 0 updates the pair's running maxima, the Z-drop
// test and the end scores, exactly as ksw2_extz2_sse.c / ksw2_extd2_sse.c
// do; the plain-XLA engine (ops/batch_xla.py) is the arithmetic
// reference this kernel is held byte-equal to.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// threads per block: launches whose planes fit in shared memory use
// kSmallBlock, long pairs (planes in global scratch, latency-bound) use
// kLargeBlock to keep more loads in flight
constexpr int kSmallBlock = 256, kLargeBlock = 1024;
constexpr int kNegInf = -0x40000000;
constexpr int kRight = 0x02, kGeneric = 0x04, kApproxMax = 0x08,
              kApproxDrop = 0x10;
constexpr int kFields = 9;

// runtime parameters, in the order of batch_xla.make_params
struct Params {
  int m, sc_mch, sc_mis, sc_N, q, e, q2, e2, qe_seed, zdrop, lthr, ldiff;
};
constexpr int kParams = 12;  // end_bonus, the 13th, acts after the forward

// shapes and structural flags of one launch
struct Launch {
  int Lq, Lt, B, flag, nc;
};

struct PairState {
  int max, max_t, max_q, mqe, mqe_t, mte, mte_q, score, zdropped;
  int fin, H0, lt, hprev;
};

__device__ __forceinline__ int8_t b8(int v) { return static_cast<int8_t>(v); }

__device__ __forceinline__ int8_t umax8(int8_t a, int8_t b) {
  return static_cast<uint8_t>(a) > static_cast<uint8_t>(b) ? a : b;
}

// ksw_apply_zdrop (ksw2.h:191-207); returns true when the run stops
__device__ bool zdrop_test(PairState& s, int H, int r, int t, int zdrop,
                           int e) {
  if (H > s.max) {
    s.max = H;
    s.max_t = t;
    s.max_q = r - t;
    return false;
  }
  if (t >= s.max_t && r - t >= s.max_q) {
    int tl = t - s.max_t, ql = (r - t) - s.max_q;
    int l = tl > ql ? tl - ql : ql - tl;
    if (zdrop >= 0 && s.max - H > zdrop + l * e) return true;
  }
  return false;
}

template <bool TWO, bool CIGAR, int kThreads>
__global__ void __launch_bounds__(kThreads)
    ext_forward(Launch L, const int* __restrict__ prm,
                const int8_t* __restrict__ Q,
                const int8_t* __restrict__ T, const int* __restrict__ QL,
                const int* __restrict__ TL, const int* __restrict__ W,
                const int8_t* __restrict__ mat, int* __restrict__ rec,
                uint8_t* __restrict__ pout, uint8_t* scratch, size_t stride,
                bool use_smem) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ PairState ps;
  __shared__ long long best_w[kThreads / 32];

  constexpr int NP = TWO ? 6 : 4;  // u v x y [x2 y2], each twice
  const Params P{prm[0], prm[1], prm[2], prm[3], prm[4],  prm[5],
                 prm[6], prm[7], prm[8], prm[9], prm[10], prm[11]};
  const int b = blockIdx.x, tid = threadIdx.x;
  const int qlen = QL[b], tlen = TL[b], w = W[b];
  const int N = L.Lt;
  const int qe = P.q + P.e, qe2 = P.q2 + P.e2;
  const int sub = TWO ? 0 : qe;          // per-step H offset
  const int ez_e = TWO ? P.e2 : P.e;     // Z-drop gap extension
  const bool right = L.flag & kRight, generic = L.flag & kGeneric;
  const bool approx = L.flag & kApproxMax;

  if (tid == 0) {
    ps.max = 0;
    ps.max_t = ps.max_q = ps.mqe_t = ps.mte_q = -1;
    ps.mqe = ps.mte = ps.score = kNegInf;
    ps.zdropped = ps.fin = ps.H0 = ps.lt = 0;
  }
  if (qlen > 0 && tlen > 0) {
    uint8_t* base = use_smem ? smem : scratch + static_cast<size_t>(b) * stride;
    int8_t* pl = reinterpret_cast<int8_t*>(base);
    int8_t* S = pl + 2 * NP * N;
    int* H = reinterpret_cast<int*>(S + N);
    auto plane = [&](int k, int buf) { return pl + (2 * k + buf) * N; };
    const int8_t init = TWO ? b8(-qe) : 0;
    for (int t = tid; t < N; t += kThreads) {
      for (int buf = 0; buf < 2; ++buf) {
        for (int k = 0; k < 4; ++k) plane(k, buf)[t] = init;
        if (TWO) {
          plane(4, buf)[t] = b8(-qe2);
          plane(5, buf)[t] = b8(-qe2);
        }
      }
      S[t] = 0;
      H[t] = kNegInf;
    }
    __syncthreads();

    const int8_t* qrow = Q + static_cast<size_t>(b) * L.Lq;
    const int8_t* trow = T + static_cast<size_t>(b) * N;
    const int n_diag = qlen + tlen - 1;
    int last_st = -1, last_en = -1;
    for (int r = 0; r < n_diag; ++r) {
      const int st0 = max(0, max(r - qlen + 1, (r - w + 1) >> 1));
      const int en0 = min(tlen - 1, min(r, (r + w) >> 1));
      if (st0 > en0) {  // empty band: the run ends as Z-dropped
        if (tid == 0) ps.zdropped = 1;
        break;
      }
      const int stb = st0 / 16 * 16, enb = (en0 + 16) / 16 * 16 - 1;
      const bool need_ov =
          stb == 0 || !(stb - 1 >= last_st && stb - 1 <= last_en);
      int8_t edge;  // first-row/column delta of this diagonal
      if (TWO)
        edge = r == 0 ? b8(-qe)
               : r < P.lthr  ? b8(-P.e)
               : r == P.lthr ? b8(P.ldiff)
                             : b8(-P.e2);
      else
        edge = r > 0 ? b8(P.q) : 0;
      const int8_t v_ov = stb == 0 ? edge : (TWO ? b8(-qe) : 0);
      const int8_t x_ov = TWO ? b8(-qe) : 0;
      const int cur = r & 1, prev = cur ^ 1;
      const int fill_hi = generic ? en0 : st0 + ((en0 - st0) / 16) * 16 + 15;
      const int en1 = st0 + (en0 - st0) / 4 * 4;
      long long best = LLONG_MIN;
      uint8_t* prow =
          CIGAR ? pout + (static_cast<size_t>(r) * L.B + b) * L.nc : nullptr;

      for (int t = stb + tid; t <= enb; t += kThreads) {
        int8_t xt1, vt1, x2t1 = 0;
        if (t == stb && need_ov) {
          xt1 = x_ov;
          vt1 = v_ov;
          x2t1 = b8(-qe2);
        } else {
          xt1 = plane(2, prev)[t - 1];
          vt1 = plane(1, prev)[t - 1];
          if (TWO) x2t1 = plane(4, prev)[t - 1];
        }
        int8_t u0, y0, y20 = 0;
        if (t == r) {  // first-column boundary cell
          u0 = edge;
          y0 = TWO ? b8(-qe) : 0;
          y20 = b8(-qe2);
        } else {
          u0 = plane(0, prev)[t];
          y0 = plane(3, prev)[t];
          if (TWO) y20 = plane(5, prev)[t];
        }
        int8_t s;
        if (t >= st0 && t <= fill_hi) {
          const int j = r - t;
          const int qs = j >= 0 ? qrow[j] : 0;
          const int ts = trow[t];
          if (generic) {
            s = mat[ts * P.m + qs];
          } else {
            s = ts == qs ? b8(P.sc_mch) : b8(P.sc_mis);
            if (ts == P.m - 1 || qs == P.m - 1) s = b8(P.sc_N);
          }
          S[t] = s;
        } else {
          s = S[t];
        }

        const int8_t a = b8(xt1 + vt1), bb = b8(y0 + u0);
        int8_t z, unew, vnew;
        uint8_t d = 0;
        if (!TWO) {
          const int8_t zz = b8(s + 2 * qe);
          if (CIGAR) d = right ? (zz <= a) : (a > zz);
          z = zz > a ? zz : a;
          if (CIGAR && (right ? (z <= bb) : (bb > z))) d = 2;
          z = umax8(z, bb);
          const uint8_t clamp = static_cast<uint8_t>(P.sc_mch + 2 * qe);
          if (static_cast<uint8_t>(z) > clamp) z = static_cast<int8_t>(clamp);
          unew = b8(z - vt1);
          vnew = b8(z - u0);
          const int8_t z2 = b8(z - P.q);
          const int8_t a1 = b8(a - z2), b1 = b8(bb - z2);
          if (CIGAR) {
            d |= (right ? a1 >= 0 : a1 > 0) << 3;
            d |= (right ? b1 >= 0 : b1 > 0) << 4;
          }
          plane(2, cur)[t] = a1 > 0 ? a1 : 0;
          plane(3, cur)[t] = b1 > 0 ? b1 : 0;
        } else {
          const int8_t a2 = b8(x2t1 + vt1), b2 = b8(y20 + u0);
          const int8_t cand[4] = {a, bb, a2, b2};
          z = s;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (CIGAR && (right ? (z <= cand[k]) : (cand[k] > z))) d = k + 1;
            z = cand[k] > z ? cand[k] : z;
          }
          if (z > b8(P.sc_mch)) z = b8(P.sc_mch);
          unew = b8(z - vt1);
          vnew = b8(z - u0);
          const int8_t t1 = b8(z - P.q), t2 = b8(z - P.q2);
          const int8_t nv[4] = {b8(a - t1), b8(bb - t1), b8(a2 - t2),
                                b8(b2 - t2)};
          const int8_t off[4] = {b8(-qe), b8(-qe), b8(-qe2), b8(-qe2)};
          const int dst[4] = {2, 3, 4, 5};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (CIGAR) d |= (right ? nv[k] >= 0 : nv[k] > 0) << (3 + k);
            plane(dst[k], cur)[t] = b8((nv[k] > 0 ? nv[k] : 0) + off[k]);
          }
        }
        plane(0, cur)[t] = unew;
        plane(1, cur)[t] = vnew;
        if (CIGAR) prow[t - stb] = d;

        if (!approx && r > 0 && t >= st0 && t < en0) {
          const int vv = TWO ? static_cast<int>(vnew)
                             : static_cast<int>(static_cast<uint8_t>(vnew));
          int h = H[t];
          // H[en0] is built from the *previous* H[en0-1]; keep it before
          // this lane overwrites it (thread 0 reads it after the barrier)
          if (t == en0 - 1) ps.hprev = h;
          h += vv - sub;
          H[t] = h;
          // the reference's 4-lane scan order: lane, then block, then tail
          const int key = t < en1 ? ((t - st0) & 3) * (1 << 26) + t
                                  : (1 << 28) + t;
          const long long pk = static_cast<long long>(h) * 4294967296LL +
                               static_cast<unsigned>(~key);
          best = pk > best ? pk : best;
        }
      }
      // the reference's unaligned profile store reaches up to 15 lanes
      // past the rounded band end; those lanes are read once the band
      // grows over them
      for (int t = enb + 1 + tid; t <= min(fill_hi, N - 1); t += kThreads) {
        const int j = r - t;
        const int qs = j >= 0 ? qrow[j] : 0;
        const int ts = trow[t];
        int8_t s = ts == qs ? b8(P.sc_mch) : b8(P.sc_mis);
        if (ts == P.m - 1 || qs == P.m - 1) s = b8(P.sc_N);
        S[t] = s;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const long long other = __shfl_xor_sync(0xffffffffu, best, o);
        best = other > best ? other : best;
      }
      if ((tid & 31) == 0) best_w[tid >> 5] = best;
      __syncthreads();

      if (tid == 0) {
        const int8_t* Vc = plane(1, cur);
        const int8_t* Uc = plane(0, cur);
        auto rv = [&](int8_t x) {
          return TWO ? static_cast<int>(x)
                     : static_cast<int>(static_cast<uint8_t>(x));
        };
        const bool last = r == qlen + tlen - 2 && en0 == tlen - 1;
        bool trig = false;
        if (!approx) {
          int h_last;
          if (r == 0) {
            h_last = rv(Vc[0]) - P.qe_seed;
          } else if (en0 > 0) {
            const int hp = en0 - 1 >= st0 ? ps.hprev : H[en0 - 1];
            h_last = hp + rv(Uc[en0]) - sub;
          } else {
            h_last = H[en0] + rv(Vc[en0]) - sub;
          }
          H[en0] = h_last;
          long long pk = LLONG_MIN;
          for (int k = 0; k < kThreads / 32; ++k)
            pk = best_w[k] > pk ? best_w[k] : pk;
          int M = h_last, max_t = en0;
          if (pk != LLONG_MIN && static_cast<int>(pk >> 32) > h_last) {
            M = static_cast<int>(pk >> 32);
            const unsigned key = ~static_cast<unsigned>(pk & 0xffffffffLL);
            max_t = static_cast<int>(key & ((1u << 26) - 1));
          }
          if (r == 0) max_t = 0;
          if (en0 == tlen - 1 && h_last > ps.mte) {
            ps.mte = h_last;
            ps.mte_q = r - enb;
          }
          if (r - st0 == qlen - 1 && H[st0] > ps.mqe) {
            ps.mqe = H[st0];
            ps.mqe_t = st0;
          }
          trig = zdrop_test(ps, M, r, max_t, P.zdrop, ez_e);
          if (!trig && last) ps.score = h_last;
        } else {
          if (r == 0) {
            ps.H0 = rv(Vc[0]) - P.qe_seed;
            ps.lt = 0;
          } else {
            const int lt = ps.lt;
            const bool c1 = lt >= st0 && lt <= en0;
            const bool c2 = lt + 1 >= st0 && lt + 1 <= en0;
            const int d0 = rv(Vc[lt]) - sub;
            const int d1 = rv(Uc[min(lt + 1, N - 1)]) - sub;
            if (c1 && c2) {
              if (d0 > d1) {
                ps.H0 += d0;
              } else {
                ps.H0 += d1;
                ps.lt = lt + 1;
              }
            } else if (c1) {
              ps.H0 += d0;
            } else {
              ps.H0 += d1;
              ps.lt = lt + 1;
            }
          }
          if ((L.flag & kApproxDrop) && (TWO || r > 0))
            trig = zdrop_test(ps, ps.H0, r, ps.lt, P.zdrop, ez_e);
          if (!trig && last) ps.score = ps.H0;
        }
        if (trig) ps.zdropped = ps.fin = 1;
      }
      __syncthreads();
      if (ps.fin) break;
      last_st = stb;
      last_en = enb;
    }
    __syncthreads();
  }
  if (tid == 0) {
    int* o = rec + static_cast<size_t>(b) * kFields;
    o[0] = ps.max;
    o[1] = ps.max_t;
    o[2] = ps.max_q;
    o[3] = ps.mqe;
    o[4] = ps.mqe_t;
    o[5] = ps.mte;
    o[6] = ps.mte_q;
    o[7] = ps.score;
    o[8] = ps.zdropped;
  }
}

template <bool TWO, bool CIGAR, int kThreads>
cudaError_t launch_with(cudaStream_t stream, const Launch& L, const int* prm,
                        const int8_t* Q, const int8_t* T, const int* ql,
                        const int* tl, const int* w, const int8_t* mat,
                        int* rec, uint8_t* p, uint8_t* scratch,
                        size_t stride, bool use_smem) {
  const size_t shmem = use_smem ? stride : 0;
  auto kern = ext_forward<TWO, CIGAR, kThreads>;
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  kern<<<L.B, kThreads, shmem, stream>>>(L, prm, Q, T, ql, tl, w, mat, rec,
                                         p, scratch, stride, use_smem);
  return cudaGetLastError();
}

template <bool TWO, bool CIGAR>
cudaError_t launch(cudaStream_t stream, const Launch& L, const int* prm,
                   const int8_t* Q, const int8_t* T, const int* ql,
                   const int* tl, const int* w, const int8_t* mat, int* rec,
                   uint8_t* p, uint8_t* scratch, size_t stride,
                   bool use_smem) {
  auto go = use_smem ? launch_with<TWO, CIGAR, kSmallBlock>
                     : launch_with<TWO, CIGAR, kLargeBlock>;
  return go(stream, L, prm, Q, T, ql, tl, w, mat, rec, p, scratch, stride,
            use_smem);
}

ffi::Error ExtForwardImpl(
    cudaStream_t stream, ffi::Buffer<ffi::S8> Q, ffi::Buffer<ffi::S8> T,
    ffi::Buffer<ffi::S32> qlen, ffi::Buffer<ffi::S32> tlen,
    ffi::Buffer<ffi::S32> w, ffi::Buffer<ffi::S8> mat,
    ffi::Buffer<ffi::S32> prm, int32_t flag, int32_t nc, int32_t two,
    int32_t use_smem, ffi::ResultBuffer<ffi::S32> rec,
    ffi::ResultBuffer<ffi::U8> p, ffi::ResultBuffer<ffi::U8> scratch) {
  auto dq = Q.dimensions(), dt = T.dimensions();
  if (dq.size() != 2 || dt.size() != 2 || dq[0] != dt[0] || dt[1] % 16)
    return ffi::Error::InvalidArgument("query/target must be (B, L), "
                                       "target width a multiple of 16");
  if (prm.element_count() < kParams)
    return ffi::Error::InvalidArgument("parameter vector too short");
  const Launch L{static_cast<int>(dq[1]), static_cast<int>(dt[1]),
                 static_cast<int>(dt[0]), flag, nc};
  if (L.B == 0) return ffi::Error::Success();
  const int np = two ? 6 : 4;
  const size_t stride = static_cast<size_t>(L.Lt) * (2 * np + 1 + 4);
  if (!use_smem && scratch->element_count() < stride * L.B)
    return ffi::Error::InvalidArgument("scratch result too small");
  if (nc) {
    cudaError_t err = cudaMemsetAsync(p->untyped_data(), 0,
                                      p->size_bytes(), stream);
    if (err != cudaSuccess)
      return ffi::Error::Internal(cudaGetErrorString(err));
  }
  auto run = [&](auto kernel_launch) {
    return kernel_launch(stream, L, prm.typed_data(), Q.typed_data(),
                         T.typed_data(), qlen.typed_data(),
                         tlen.typed_data(), w.typed_data(), mat.typed_data(),
                         rec->typed_data(),
                         reinterpret_cast<uint8_t*>(p->untyped_data()),
                         reinterpret_cast<uint8_t*>(scratch->untyped_data()),
                         stride, use_smem != 0);
  };
  cudaError_t err = two ? (nc ? run(launch<true, true>)
                              : run(launch<true, false>))
                        : (nc ? run(launch<false, true>)
                              : run(launch<false, false>));
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    Ksw2ExtForward, ExtForwardImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Attr<int32_t>("flag")
        .Attr<int32_t>("nc")
        .Attr<int32_t>("two")
        .Attr<int32_t>("use_smem")
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::U8>>()
        .Ret<ffi::Buffer<ffi::U8>>());
