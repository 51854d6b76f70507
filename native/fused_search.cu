// Fused search step for NVIDIA Hopper (sm_90a), called from JAX through
// the XLA FFI (document_search_engine_tpu/ops/fused_cuda.py).
//
// One thread block serves one plan row (a query, or a doc-range piece of
// one). It reads the row's CSR block ranges straight from the resident
// (X, 128) posting planes, quantizes every posting to its int32
// fixed-point contribution (DESIGN.md §2: rne((A_s * val) * 2^scale),
// clipped), and stores only the real postings, granule-compacted at the
// dstrow offsets of the plan tables, in shared memory. A CUB block radix
// sort orders the (doc, contribution) pairs by doc, each doc's run of at
// most S contributions is summed in integers, and a block radix select
// over the (score, -doc) keys picks the top k. The candidate buffer never
// leaves shared memory.
//
// Every step is exact integer math on identically rounded f32 products,
// so the result is bit-identical to the XLA twin (ops/packed.py
// search_packed_tables) and to the CPU oracle. The two f32 multiplies use
// __fmul_rn and the library is built with --fmad=false, so neither can
// be contracted into an FMA.
//
// Build (done at first use by fused_cuda.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -I <jax.ffi.include_dir()>
//        -o build/libdse_cuda.so native/fused_search.cu

#include <cstdint>
#include <string>

#include <cuda_runtime.h>
#include <cub/block/block_radix_sort.cuh>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kLanes = 128;  // records per plane row (index/csr.py LANES)
constexpr int kMaxK = 128;   // largest k the kernel ranks
constexpr int kUnroll = 4;   // posting loads in flight per thread

template <int THREADS, int IPT>
struct Smem {
  static constexpr int kCap = THREADS * IPT;  // candidate slots
  using Sort = cub::BlockRadixSort<unsigned int, THREADS, IPT, int>;
  union {
    typename Sort::TempStorage sort;
    struct {
      unsigned int key[kCap];  // local doc id (n_docs = empty slot)
      int ci[kCap];            // int32 fixed-point contribution
    } buf;
  } u;
  unsigned int hist[256];
  unsigned long long sel[kMaxK];
  int n_sel;
  int digit;
  int remaining;
};

// Candidate key: larger is better. Score in bits [31, 62), 0x7fffffff - doc
// in bits [0, 31): ties in score break by ascending doc id, and keys of
// distinct docs never tie. 0 marks "no candidate".
__device__ __forceinline__ unsigned long long cand_key(int score,
                                                       unsigned int doc) {
  return (static_cast<unsigned long long>(score) << 31) |
         static_cast<unsigned long long>(0x7fffffffu - doc);
}

template <int THREADS, int IPT>
__global__ void __launch_bounds__(THREADS)
    fused_search_kernel(const int* __restrict__ post_doc,
                        const int* __restrict__ post_val,
                        const int* __restrict__ srcrow,
                        const int* __restrict__ rem,
                        const int* __restrict__ abits,
                        const int* __restrict__ dstrow,
                        const int* __restrict__ dlim,
                        int* __restrict__ out_vals, int* __restrict__ out_docs,
                        int n_blocks, int block, int k, int n_docs,
                        int has_dlim, int end_bit, float scale, float clip) {
  using S = Smem<THREADS, IPT>;
  constexpr int C = S::kCap;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const unsigned int sentinel = static_cast<unsigned int>(n_docs);

  for (int i = tid; i < C; i += THREADS) {
    sm.u.buf.key[i] = sentinel;
    sm.u.buf.ci[i] = 0;
  }
  if (tid == 0) {
    sm.n_sel = 0;
    sm.remaining = k;
  }
  int d_lo = 0, d_hi = n_docs;
  if (has_dlim) {
    d_lo = dlim[2 * q];
    d_hi = dlim[2 * q + 1];
  }
  __syncthreads();

  // 1. gather + quantize + compacted store
  const size_t row = static_cast<size_t>(q) * n_blocks;
  for (int j = 0; j < n_blocks; ++j) {
    const int src = srcrow[row + j];
    if (src < 0) continue;  // skipped block: zero compacted rows
    const int valid_n = min(max(rem[row + j], 0), block);
    const int n_store = (valid_n + kLanes - 1) / kLanes * kLanes;
    const int dst = dstrow[row + j] * kLanes;
    const float a = __int_as_float(abits[row + j]);
    const int* pd = post_doc + static_cast<size_t>(src) * kLanes;
    const int* pv = post_val + static_cast<size_t>(src) * kLanes;
    for (int i0 = tid; i0 < n_store; i0 += THREADS * kUnroll) {
      int d[kUnroll], v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * THREADS;
        d[u] = n_docs;
        v[u] = 0;
        if (i < valid_n) {
          d[u] = __ldg(pd + i);
          v[u] = __ldg(pv + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * THREADS;
        if (i >= n_store || dst + i >= C) continue;
        unsigned int key = sentinel;
        int c = 0;
        if (i < valid_n && d[u] >= d_lo && d[u] < d_hi) {
          float cf = rintf(__fmul_rn(__fmul_rn(a, __int_as_float(v[u])), scale));
          cf = fminf(fmaxf(cf, 0.0f), clip);
          key = static_cast<unsigned int>(d[u]);
          c = static_cast<int>(cf);
        }
        sm.u.buf.key[dst + i] = key;
        sm.u.buf.ci[dst + i] = c;
      }
    }
  }
  __syncthreads();

  // 2. sort the pairs by doc (input order is irrelevant: load striped,
  // conflict-free; the output comes back striped in sorted order)
  unsigned int keys[IPT];
  int vals[IPT];
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    keys[i] = sm.u.buf.key[i * THREADS + tid];
    vals[i] = sm.u.buf.ci[i * THREADS + tid];
  }
  __syncthreads();  // the buffer aliases the sort's temp storage
  typename S::Sort(sm.u.sort).SortBlockedToStriped(keys, vals, 0, end_bit);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    sm.u.buf.key[i * THREADS + tid] = keys[i];
    sm.u.buf.ci[i * THREADS + tid] = vals[i];
  }
  __syncthreads();

  // 3. run-sums: a doc's contributions are adjacent after the sort; the
  // last position of each run carries the doc's integer score
  unsigned long long ck[IPT];
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int p = i * THREADS + tid;
    const unsigned int key = sm.u.buf.key[p];
    ck[i] = 0ull;
    const bool last = (p == C - 1) || (sm.u.buf.key[p + 1] != key);
    if (last && key < sentinel) {
      int sum = 0;
      for (int j = p; j >= 0 && sm.u.buf.key[j] == key; --j) {
        sum += sm.u.buf.ci[j];
      }
      if (sum > 0) ck[i] = cand_key(sum, key);
    }
  }

  // 4. radix select: the k-th largest candidate key, 8 bits per pass from
  // the top (C >= k, so the k-th largest always exists; non-candidates
  // are 0)
  unsigned long long prefix = 0ull, mask = 0ull;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += THREADS) sm.hist[i] = 0u;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if ((ck[i] & mask) == prefix) {
        atomicAdd(&sm.hist[(ck[i] >> shift) & 255ull], 1u);
      }
    }
    __syncthreads();
    if (tid < 32) {
      // lane l owns digits 255-8l .. 248-8l (descending)
      const int lane = tid;
      unsigned int h[8];
      unsigned int local = 0u;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        h[m] = sm.hist[255 - (lane * 8 + m)];
        local += h[m];
      }
      unsigned int incl = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const unsigned int excl = incl - local;
      const unsigned int want = static_cast<unsigned int>(sm.remaining);
      const unsigned int hit = __ballot_sync(
          0xffffffffu, excl < want && incl >= want);
      const int src_lane = hit ? __ffs(hit) - 1 : 31;
      if (lane == src_lane) {
        unsigned int c = excl;
        int digit = 0;
        for (int m = 0; m < 8; ++m) {
          if (c + h[m] >= want) {
            digit = 255 - (lane * 8 + m);
            break;
          }
          c += h[m];
        }
        sm.digit = digit;
        sm.remaining = static_cast<int>(want - c);
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(sm.digit) << shift;
    mask |= 255ull << shift;
    __syncthreads();
  }

  // 5. the selected set: every key above the threshold, plus the
  // threshold itself when it is a real candidate (keys are unique)
  const unsigned long long thr = prefix;
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    if (ck[i] > thr || (ck[i] == thr && thr != 0ull)) {
      const int slot = atomicAdd(&sm.n_sel, 1);
      if (slot < kMaxK) sm.sel[slot] = ck[i];
    }
  }
  __syncthreads();
  const int n = min(sm.n_sel, k);
  int* ov = out_vals + static_cast<size_t>(q) * k;
  int* od = out_docs + static_cast<size_t>(q) * k;
  for (int t = tid; t < k; t += THREADS) {
    if (t < n) {
      const unsigned long long me = sm.sel[t];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += sm.sel[j] > me ? 1 : 0;
      ov[rank] = static_cast<int>(me >> 31);
      od[rank] = static_cast<int>(0x7fffffffu -
                                  static_cast<unsigned int>(me & 0x7fffffffull));
    } else {
      ov[t] = -1;
      od[t] = -1;
    }
  }
}

template <int THREADS, int IPT>
cudaError_t launch(cudaStream_t stream, int nq, const int* post_doc,
                   const int* post_val, const int* srcrow, const int* rem,
                   const int* abits, const int* dstrow, const int* dlim,
                   int* out_vals, int* out_docs, int n_blocks, int block,
                   int k, int n_docs, int has_dlim, int end_bit, float scale,
                   float clip) {
  auto kernel = fused_search_kernel<THREADS, IPT>;
  const int smem = static_cast<int>(sizeof(Smem<THREADS, IPT>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nq, THREADS, smem, stream>>>(
      post_doc, post_val, srcrow, rem, abits, dstrow, dlim, out_vals,
      out_docs, n_blocks, block, k, n_docs, has_dlim, end_bit, scale, clip);
  return cudaGetLastError();
}

ffi::Error FusedSearch(cudaStream_t stream, ffi::Buffer<ffi::S32> post_doc,
                       ffi::Buffer<ffi::S32> post_val,
                       ffi::Buffer<ffi::S32> srcrow,
                       ffi::Buffer<ffi::S32> rem,
                       ffi::Buffer<ffi::S32> abits,
                       ffi::Buffer<ffi::S32> dstrow,
                       ffi::Buffer<ffi::S32> dlim,
                       ffi::ResultBuffer<ffi::S32> out_vals,
                       ffi::ResultBuffer<ffi::S32> out_docs, int64_t block,
                       int64_t cap, int64_t k, int64_t n_docs,
                       int64_t has_dlim, float scale, float clip) {
  const auto dims = srcrow.dimensions();
  const int nq = static_cast<int>(dims[0]);
  const int n_blocks = static_cast<int>(dims[dims.size() - 1]);
  if (k < 1 || k > kMaxK) {
    return ffi::Error::InvalidArgument("k must be in [1, 128]");
  }
  if (nq == 0) return ffi::Error::Success();
  int end_bit = 1;
  while ((1ll << end_bit) <= n_docs) ++end_bit;
  const int* a0 = post_doc.typed_data();
  const int* a1 = post_val.typed_data();
  const int* a2 = srcrow.typed_data();
  const int* a3 = rem.typed_data();
  const int* a4 = abits.typed_data();
  const int* a5 = dstrow.typed_data();
  const int* a6 = dlim.typed_data();
  int* ov = out_vals->typed_data();
  int* od = out_docs->typed_data();
  const int b = static_cast<int>(block), kk = static_cast<int>(k);
  const int nd = static_cast<int>(n_docs), hd = static_cast<int>(has_dlim);
  cudaError_t err;
  switch (cap) {
    case 1024:
      err = launch<128, 8>(stream, nq, a0, a1, a2, a3, a4, a5, a6, ov, od,
                           n_blocks, b, kk, nd, hd, end_bit, scale, clip);
      break;
    case 2048:
      err = launch<256, 8>(stream, nq, a0, a1, a2, a3, a4, a5, a6, ov, od,
                           n_blocks, b, kk, nd, hd, end_bit, scale, clip);
      break;
    case 4096:
      err = launch<256, 16>(stream, nq, a0, a1, a2, a3, a4, a5, a6, ov, od,
                            n_blocks, b, kk, nd, hd, end_bit, scale, clip);
      break;
    case 8192:
      err = launch<512, 16>(stream, nq, a0, a1, a2, a3, a4, a5, a6, ov, od,
                            n_blocks, b, kk, nd, hd, end_bit, scale, clip);
      break;
    case 16384:
      err = launch<512, 32>(stream, nq, a0, a1, a2, a3, a4, a5, a6, ov, od,
                            n_blocks, b, kk, nd, hd, end_bit, scale, clip);
      break;
    default:
      return ffi::Error::InvalidArgument(
          "cap must be a power of two in [1024, 16384]");
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("fused_search launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(DseFusedSearch, FusedSearch,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // post_doc
                                  .Arg<ffi::Buffer<ffi::S32>>()  // post_val
                                  .Arg<ffi::Buffer<ffi::S32>>()  // srcrow
                                  .Arg<ffi::Buffer<ffi::S32>>()  // rem
                                  .Arg<ffi::Buffer<ffi::S32>>()  // abits
                                  .Arg<ffi::Buffer<ffi::S32>>()  // dstrow
                                  .Arg<ffi::Buffer<ffi::S32>>()  // dlim
                                  .Ret<ffi::Buffer<ffi::S32>>()  // vals
                                  .Ret<ffi::Buffer<ffi::S32>>()  // docs
                                  .Attr<int64_t>("block")
                                  .Attr<int64_t>("cap")
                                  .Attr<int64_t>("k")
                                  .Attr<int64_t>("n_docs")
                                  .Attr<int64_t>("has_dlim")
                                  .Attr<float>("scale")
                                  .Attr<float>("clip"));
