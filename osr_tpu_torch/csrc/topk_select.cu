// Exact top-k selection along rows for Hopper (sm_90a).
//
// Replaces no TPU kernel: osr_tpu selects with lax.top_k, which is XLA's own
// primitive and has no Pallas kernel. It was added because the port's
// selection (ops/topk.py:topk) was a stable full sort of every row that kept
// only the first k entries, and that sort took most of the card's time in the
// sparse cells (about 86% of fiqa-bm25.top1000's).
//
// What it computes, for x (rows, n) float32 or int32 with unit column stride
// and 1 <= k < n: per row, the k largest entries in descending order with
// their int32 columns, ties resolved toward the lower column; exactly
// torch.sort(x, descending=True, stable=True)[..., :k], values bit for bit.
// Order keys: a float maps to a uint32 whose unsigned order is the floats'
// order, with -0.0 folded into +0.0 and every NaN above +inf and equal to the
// others (torch.sort's order); an int32 flips its sign bit. Values are
// copied from the row, so -0.0 and NaN payloads come out as they went in.
//
// Bound. The work is a read of the row: at the FiQA full-row shape (3,328 x
// 57,728, k = 1,000) 768.5 MB read and 26.6 MB written, 0.2373 ms at 3.35
// TB/s; at one MS MARCO sweep's candidates (3,496 x 128,000, k = 1,000) 1.79
// GB and 28 MB, 0.5427 ms. The arithmetic is a few integer operations an
// entry.
//
// Design. Rows of at most kWarpMaxN (1,024) entries with k at most
// kWarpMaxK (64), such as block_topm's (B, G, 128) blocks and the FiQA block
// maxima, take a warp a row (topk_select_warp_kernel): each lane holds the
// keys of columns lane + 32 j in registers, and k rounds of a warp-wide
// maximum of the (key, ~column) word, 5 shuffles each, pick the survivors in
// their order; no shared memory, no sort. Other rows take a thread block a
// row, 256 threads (four blocks an SM), 41 KB of shared memory:
// - A row of at most kStage (4,096) entries is staged whole in shared memory
//   as 64-bit (key, ~column) words, one read.
// - Wider rows: a radix select on the key, 11 bits a digit (bits 31-21,
//   20-10, 10-0), one pass over the row a digit with 16-byte loads and a
//   histogram of the digit in shared memory (plain atomics: warp-aggregated
//   ones cost twice as much on Gaussian scores and saved little on tied
//   ones) among the entries whose higher digits equal the chosen prefix.
//   After each digit, once the entries above the chosen bucket and those in
//   it number at most kStage, one more pass stages exactly those. Each pass
//   also takes the least and the greatest key it counts; when they are
//   equal (an all-tied bucket, such as a row of zero scores) the k-th key
//   tau is known and no digit pass is left.
// - Otherwise (many entries tie at tau), one ordered pass over the row in
//   tiles of 1,024 entries in column order: a block-wide prefix scan places
//   every entry above tau and the first k - n_gt entries equal to tau, and
//   the pass stops once all k are placed.
// - Staged words are distinct, so the k largest words are the k survivors,
//   ties to the lower column. A radix select on the 64-bit word in shared
//   memory (select_in_stage; each round counts the 11 bits below the
//   highest bit its candidates differ in) keeps exactly k, and a bitonic
//   sort of those k (padded to a power of two) orders them: the sort is
//   bound by shared-memory bandwidth, 16 bytes a word a step, so it sorts k
//   words and not the up to 4,096 staged. The values and int32 columns go
//   straight into the (rows, k) outputs.
// Measured on an H100 (PERF.md §6): a pass over the FiQA rows alone
// runs at 87% of the byte bound, and later passes find little of a row in
// L2. Tried and dropped: 512 threads, two or three blocks an SM, or one
// block an SM (slower: the select and the sort need other blocks beside
// them), and one pass that streams the row through the stage and shrinks
// it as it fills (slower: a barrier a slice and about eight select rounds a
// row cost more than the pass it saves).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 4096;  // staged (key, column) words
constexpr int kMaxK = kStage;  // the k survivors live in the stage
constexpr int kBins = 2048;    // 11-bit digits
constexpr int kUnroll = 4;     // 16-byte loads a thread keeps in flight
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpMaxN = 1024;  // a row a warp: at most 32 entries a lane
constexpr int kWarpMaxK = 64;

constexpr int kBinsPerThread = kBins / kThreads;

static_assert(kBins % kThreads == 0, "find_bucket gives each thread whole bins");
static_assert(4 * kThreads < 65536, "compact packs two tile counts in a word");

struct Smem {
  unsigned long long stage[kStage];
  uint32_t hist[kBins];
  uint32_t scan[kWarps];
  unsigned long long wmin;  // least and greatest staged word a pass matched
  unsigned long long wmax;
  uint32_t count;   // staged words
  uint32_t kmin;    // least key a pass looked at
  uint32_t kmax;    // greatest
  uint32_t bucket;  // find_bucket's bin, the count above it, its count
  uint32_t above;
  uint32_t in_bucket;
};

template <bool kFloat>
__device__ __forceinline__ uint32_t order_key(uint32_t bits) {
  if (!kFloat) return bits ^ 0x80000000u;
  if ((bits & 0x7FFFFFFFu) > 0x7F800000u) return 0xFFFFFFFFu;  // NaN
  if (bits == 0x80000000u) bits = 0u;                            // -0.0
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// Descending order of these words is (key descending, column ascending);
// 0 is below every real word (a column is below 2^31).
__device__ __forceinline__ unsigned long long pack(uint32_t key, int col) {
  return (static_cast<unsigned long long>(key) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(col));
}

// Calls f(bits, column, valid) for each entry of the row, a thread on its own
// entries. Every thread makes the same calls in the same order, so warp-wide
// intrinsics inside f see whole warps. A row whose start is not 16-byte
// aligned takes its first 1-3 entries apart; the last 0-3 likewise.
template <class F>
__device__ __forceinline__ void visit_row(const uint32_t* row, int n, F&& f) {
  const int tid = threadIdx.x;
  const int head = min(
      n, static_cast<int>(
             ((16u - (static_cast<uint32_t>(
                         reinterpret_cast<uintptr_t>(row)) & 15u)) & 15u) >> 2));
  f(tid < head ? row[tid] : 0u, tid, tid < head);
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const int nv = (n - head) >> 2;
  for (int base = 0; base < nv; base += kThreads * kUnroll) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads + tid;
      q[u] = v < nv ? __ldg(body + v) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads + tid;
      const bool ok = v < nv;
      const int i = head + 4 * v;
      f(q[u].x, i, ok);
      f(q[u].y, i + 1, ok);
      f(q[u].z, i + 2, ok);
      f(q[u].w, i + 3, ok);
    }
  }
  const int t = head + 4 * nv + tid;
  f(t < n ? row[t] : 0u, t, t < n);
}

// Exclusive prefix sum of v over the block, in thread order; total gets the
// block's sum. Every thread must call it.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t* warp_sums,
                                                         uint32_t v,
                                                         uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();  // the last call's readers of warp_sums are done
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[kWarps - 1];
  return (warp ? warp_sums[warp - 1] : 0u) + x - v;
}

// Histogram of key bits [shift, shift + 11) over the entries whose key
// matches prefix under pmask, and the least and greatest of their keys.
template <bool kFloat>
__device__ void histogram(Smem& sm, const uint32_t* row, int n,
                          uint32_t prefix, uint32_t pmask, int shift) {
  const int lane = threadIdx.x & 31;
  uint32_t lo = 0xFFFFFFFFu, hi = 0u;
  visit_row(row, n, [&](uint32_t bits, int, bool ok) {
    const uint32_t key = order_key<kFloat>(bits);
    const bool in = ok && (key & pmask) == prefix;
    if (!__any_sync(kFull, in)) return;
    if (in) {
      lo = min(lo, key);
      hi = max(hi, key);
    }
    if (in) atomicAdd(&sm.hist[(key >> shift) & (kBins - 1)], 1u);
  });
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    atomicMin(&sm.kmin, lo);
    atomicMax(&sm.kmax, hi);
  }
  __syncthreads();
}

// The bin, counted from the top, in which the need-th entry lies: sets
// bucket, above (entries in higher bins) and in_bucket.
__device__ void find_bucket(Smem& sm, uint32_t need) {
  const int tid = threadIdx.x;
  uint32_t h[kBinsPerThread], sum = 0;
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    h[j] = sm.hist[kBins - 1 - kBinsPerThread * tid - j];
    sum += h[j];
  }
  uint32_t total;
  uint32_t before = block_exclusive_scan(sm.scan, sum, total);
  if (before < need && before + sum >= need) {
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      if (before + h[j] >= need) {
        sm.bucket = kBins - 1 - kBinsPerThread * tid - j;
        sm.above = before;
        sm.in_bucket = h[j];
        break;
      }
      before += h[j];
    }
  }
  __syncthreads();
}

// Appends every entry whose key is at least lo to the stage, in no order.
template <bool kFloat>
__device__ void stage_from(Smem& sm, const uint32_t* row, int n, uint32_t lo) {
  const int lane = threadIdx.x & 31;
  visit_row(row, n, [&](uint32_t bits, int col, bool ok) {
    const uint32_t key = order_key<kFloat>(bits);
    const bool take = ok && key >= lo;
    const unsigned ballot = __ballot_sync(kFull, take);
    if (!ballot) return;
    const int leader = __ffs(ballot) - 1;
    uint32_t base = 0;
    if (lane == leader) base = atomicAdd(&sm.count, __popc(ballot));
    base = __shfl_sync(kFull, base, leader);
    if (take) {
      sm.stage[base + __popc(ballot & ((1u << lane) - 1u))] = pack(key, col);
    }
  });
  __syncthreads();
}

// Places every entry above tau (stage[0, n_gt)) and the first need entries
// equal to tau in column order (stage[n_gt, n_gt + need)), walking the row
// in column order and stopping once all are placed.
template <bool kFloat>
__device__ void compact(Smem& sm, const uint32_t* row, int n, uint32_t tau,
                        uint32_t n_gt, uint32_t need) {
  const int tid = threadIdx.x;
  uint32_t wbase = 0, tbase = 0;
  // This thread's cnt consecutive entries from column first; true once done.
  auto tile = [&](const uint32_t (&bits)[4], int first, int cnt) {
    uint32_t key[4], w = 0, c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      key[j] = order_key<kFloat>(bits[j]);
      if (j < cnt) {
        w += key[j] > tau;
        c += key[j] == tau;
      }
    }
    uint32_t total;
    const uint32_t ex = block_exclusive_scan(sm.scan, (w << 16) | c, total);
    uint32_t wp = wbase + (ex >> 16), tp = tbase + (ex & 0xFFFFu);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < cnt) {
        if (key[j] > tau) {
          sm.stage[wp++] = pack(key[j], first + j);
        } else if (key[j] == tau) {
          if (tp < need) sm.stage[n_gt + tp] = pack(key[j], first + j);
          ++tp;
        }
      }
    }
    wbase += total >> 16;
    tbase += total & 0xFFFFu;
    return wbase == n_gt && tbase >= need;
  };
  const int head = min(
      n, static_cast<int>(
             ((16u - (static_cast<uint32_t>(
                         reinterpret_cast<uintptr_t>(row)) & 15u)) & 15u) >> 2));
  {
    const uint32_t b[4] = {tid < head ? row[tid] : 0u, 0u, 0u, 0u};
    if (tile(b, tid, tid < head ? 1 : 0)) return;
  }
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const int nv = (n - head) >> 2;
  uint4 next = tid < nv ? __ldg(body + tid) : make_uint4(0u, 0u, 0u, 0u);
  for (int base = 0; base < nv; base += kThreads) {
    const int v = base + tid;
    const uint4 q = next;
    const int vn = v + kThreads;
    next = vn < nv ? __ldg(body + vn) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t b[4] = {q.x, q.y, q.z, q.w};
    if (tile(b, head + 4 * v, v < nv ? 4 : 0)) return;
  }
  const int t = head + 4 * nv + tid;
  const uint32_t b[4] = {t < n ? row[t] : 0u, 0u, 0u, 0u};
  tile(b, t, t < n ? 1 : 0);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Moves the k largest of the m (> k) staged words, which are distinct, to
// stage[0, k) in no order: a radix select on the 64-bit word in shared
// memory. Each round takes the least and the greatest of the words that
// still hold the k-th, whose shared leading bits are then known, and counts
// the 11-bit digit that starts at their highest differing bit; a round
// whose chosen bin is taken whole ends it.
__device__ void select_in_stage(Smem& sm, uint32_t m, uint32_t k) {
  const int tid = threadIdx.x, lane = tid & 31;
  unsigned long long prefix = 0, pmask = 0;
  uint32_t need = k;
  if (tid == 0) {
    sm.wmin = ~0ull;
    sm.wmax = 0ull;
  }
  __syncthreads();
  while (true) {
    unsigned long long lo = ~0ull, hi = 0ull;
    for (uint32_t w = tid; w < m; w += kThreads) {
      const unsigned long long x = sm.stage[w];
      if ((x & pmask) == prefix) {
        lo = min(lo, x);
        hi = max(hi, x);
      }
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      atomicMin(&sm.wmin, lo);
      atomicMax(&sm.wmax, hi);
    }
    for (int i = tid; i < kBins; i += kThreads) sm.hist[i] = 0;
    __syncthreads();
    const unsigned long long wmin = sm.wmin;
    const int top = 63 - __clzll(wmin ^ sm.wmax);  // highest differing bit
    const int shift = max(0, top - 10);
    for (uint32_t w = tid; w < m; w += kThreads) {
      const unsigned long long x = sm.stage[w];
      if ((x & pmask) == prefix) {
        atomicAdd(&sm.hist[(x >> shift) & (kBins - 1)], 1u);
      }
    }
    __syncthreads();
    find_bucket(sm, need);
    const unsigned long long shared_bits =
        top == 63 ? 0ull : ~((2ull << top) - 1ull);
    need -= sm.above;
    prefix = (wmin & shared_bits) |
             (static_cast<unsigned long long>(sm.bucket) << shift);
    pmask = shared_bits | (static_cast<unsigned long long>(kBins - 1) << shift);
    if (sm.in_bucket == need) break;
    __syncthreads();
    if (tid == 0) {
      sm.wmin = ~0ull;
      sm.wmax = 0ull;
    }
    __syncthreads();
  }
  // The words from prefix up (its lower bits are 0) are the k largest.
  // Compacted in place a slice of kThreads words at a time: every write
  // lands below the end of the slices already read.
  if (tid == 0) sm.count = 0;
  for (uint32_t base = 0; base < m; base += kThreads) {
    const uint32_t w = base + tid;
    const unsigned long long x = w < m ? sm.stage[w] : 0ull;
    const bool take = w < m && x >= prefix;
    __syncthreads();
    const unsigned ballot = __ballot_sync(kFull, take);
    if (ballot) {
      const int leader = __ffs(ballot) - 1;
      uint32_t at = 0;
      if (lane == leader) at = atomicAdd(&sm.count, __popc(ballot));
      at = __shfl_sync(kFull, at, leader);
      if (take) sm.stage[at + __popc(ballot & ((1u << lane) - 1u))] = x;
    }
  }
  __syncthreads();
}

// Sorts the m staged words descending (bitonic, padded to a power of two
// with 0) and writes the first k: values copied from the row, int32 columns.
__device__ void sort_and_write(Smem& sm, uint32_t m, int k,
                               const uint32_t* row, uint32_t* values,
                               int32_t* indices) {
  const uint32_t tid = threadIdx.x;
  uint32_t p = 1;
  while (p < m) p <<= 1;
  for (uint32_t i = m + tid; i < p; i += kThreads) sm.stage[i] = 0ull;
  __syncthreads();
  for (uint32_t size = 2; size <= p; size <<= 1) {
    for (uint32_t stride = size >> 1; stride > 0; stride >>= 1) {
      for (uint32_t t = tid; t < p / 2; t += kThreads) {
        const uint32_t i = 2 * t - (t & (stride - 1));
        const uint32_t j = i + stride;
        const unsigned long long a = sm.stage[i], b = sm.stage[j];
        if ((i & size) == 0 ? a < b : a > b) {
          sm.stage[i] = b;
          sm.stage[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += kThreads) {
    const uint32_t col = ~static_cast<uint32_t>(sm.stage[i]);
    indices[i] = static_cast<int32_t>(col);
    values[i] = row[col];
  }
}

template <bool kFloat>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    topk_select_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ values,
                       int32_t* __restrict__ indices, int n, long long stride,
                       int k) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const uint32_t* row = x + static_cast<long long>(blockIdx.x) * stride;
  uint32_t* vrow = values + static_cast<long long>(blockIdx.x) * k;
  int32_t* irow = indices + static_cast<long long>(blockIdx.x) * k;
  if (tid == 0) sm.count = 0;
  if (n <= kStage) {
    __syncthreads();
    stage_from<kFloat>(sm, row, n, 0u);
    select_in_stage(sm, n, k);
    sort_and_write(sm, k, k, row, vrow, irow);
    return;
  }
  // The entries whose key matches prefix under pmask hold the k-th: cnt of
  // them, need of which are in the top k, below n_gt entries above them.
  uint32_t prefix = 0, pmask = 0, n_gt = 0, need = k, cnt = n;
  for (int d = 0; d < 3; ++d) {
    const int shift = d == 0 ? 21 : (d == 1 ? 10 : 0);
    for (int i = tid; i < kBins; i += kThreads) sm.hist[i] = 0;
    if (tid == 0) {
      sm.kmin = 0xFFFFFFFFu;
      sm.kmax = 0u;
    }
    __syncthreads();
    histogram<kFloat>(sm, row, n, prefix, pmask, shift);
    if (sm.kmin == sm.kmax) {  // all cnt entries equal: tau is known
      prefix = sm.kmin;
      break;
    }
    find_bucket(sm, need);
    n_gt += sm.above;
    need -= sm.above;
    cnt = sm.in_bucket;
    prefix |= sm.bucket << shift;
    pmask |= static_cast<uint32_t>(kBins - 1) << shift;
    if (n_gt + cnt <= kStage) {
      stage_from<kFloat>(sm, row, n, prefix);
      if (n_gt + cnt > static_cast<uint32_t>(k)) {
        select_in_stage(sm, n_gt + cnt, k);
      }
      sort_and_write(sm, k, k, row, vrow, irow);
      return;
    }
  }
  compact<kFloat>(sm, row, n, prefix, n_gt, need);
  __syncthreads();
  sort_and_write(sm, k, k, row, vrow, irow);
}

// A warp a row, kWarps rows a block; each lane holds kE keys (columns
// lane + 32 j, j < kE, kE = ceil(n / 32) rounded up to 4, 16 or 32).
template <bool kFloat, int kE>
__global__ void __launch_bounds__(kThreads)
    topk_select_warp_kernel(const uint32_t* __restrict__ x,
                            uint32_t* __restrict__ values,
                            int32_t* __restrict__ indices, int rows, int n,
                            long long stride, int k) {
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const uint32_t* row = x + r * stride;
  uint32_t key[kE];
  uint32_t out = 0;  // bit j: column lane + 32 j is taken or past the row
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int c = lane + 32 * j;
    key[j] = c < n ? order_key<kFloat>(row[c]) : 0u;
    if (c >= n) out |= 1u << j;
  }
  uint32_t* vrow = values + r * k;
  int32_t* irow = indices + r * k;
  for (int i = 0; i < k; ++i) {
    unsigned long long best = 0ull;  // below every word
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const unsigned long long w = pack(key[j], lane + 32 * j);
      if (!((out >> j) & 1u) && w > best) best = w;
    }
    best = warp_max(best);
    const uint32_t col = ~static_cast<uint32_t>(best);
    if ((col & 31u) == static_cast<uint32_t>(lane)) out |= 1u << (col >> 5);
    if (lane == (i & 31)) {
      irow[i] = static_cast<int32_t>(col);
      vrow[i] = row[col];
    }
  }
}

template <bool kFloat>
void launch(const uint32_t* in, uint32_t* v, int32_t* ix, int rows, int n,
            long long stride, int k, cudaStream_t s) {
  if (n <= kWarpMaxN && k <= kWarpMaxK) {
    const int blocks = (rows + kWarps - 1) / kWarps;
    if (n <= 128) {
      topk_select_warp_kernel<kFloat, 4>
          <<<blocks, kThreads, 0, s>>>(in, v, ix, rows, n, stride, k);
    } else if (n <= 512) {
      topk_select_warp_kernel<kFloat, 16>
          <<<blocks, kThreads, 0, s>>>(in, v, ix, rows, n, stride, k);
    } else {
      topk_select_warp_kernel<kFloat, 32>
          <<<blocks, kThreads, 0, s>>>(in, v, ix, rows, n, stride, k);
    }
  } else {
    topk_select_kernel<kFloat><<<rows, kThreads, 0, s>>>(in, v, ix, n, stride,
                                                         k);
  }
}

}  // namespace

// x: rows rows of n entries (float32 when is_int is 0, else int32), row r
// at x + r * stride entries, columns contiguous; values (rows, k) of x's
// type and indices (rows, k) int32, contiguous. Requires 1 <= k < n,
// k <= osr_topk_select_max_k() and stride >= n when rows > 1.
extern "C" int osr_topk_select(const void* x, void* values, void* indices,
                               int rows, int n, long long stride, int k,
                               int is_int, void* stream) {
  if (rows < 0 || k < 1 || k > kMaxK || n <= k || (rows > 1 && stride < n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint32_t*>(x);
  auto* v = static_cast<uint32_t*>(values);
  auto* ix = static_cast<int32_t*>(indices);
  if (is_int) {
    launch<false>(in, v, ix, rows, n, stride, k, s);
  } else {
    launch<true>(in, v, ix, rows, n, stride, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int osr_topk_select_max_k() { return kMaxK; }

extern "C" const char* osr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
