// Native helpers for host-side plan construction (symbolic passes).
//
// The once-per-pattern symbolic passes (segment-tile layout, SpGEMM product
// schedules) are dominated by argsorts of fused integer keys; NumPy's
// comparison sort runs at ~1 M keys/s on the small deployment hosts this
// library targets.  This stable LSD radix argsort is ~10x faster and keeps
// plan-build latency proportionate to the transfer/compile costs around it.
//
// Build: g++ -O3 -shared -fPIC -o _build/_plansort.so _plansort.cpp
// (lazy, via sparse_tpu_torch/native/plansort.py; NumPy fallback if
// unavailable).  A verbatim copy of sparse_tpu/native/_plansort.cpp: the
// port cannot import the reference package (it imports jax).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Stable argsort of u64 keys: fills idx with a permutation such that
// keys[idx[i]] is non-decreasing and equal keys keep input order.
// Returns 0 on success, nonzero on bad arguments.
long long radix_argsort_u64(const uint64_t* keys, long long n,
                            long long* idx) {
  if (n < 0 || (n > 0 && (!keys || !idx))) return 1;
  if (n == 0) return 0;
  uint64_t maxk = 0;
  for (long long i = 0; i < n; ++i) {
    idx[i] = i;
    if (keys[i] > maxk) maxk = keys[i];
  }
  int passes = 1;
  while (passes < 8 && (maxk >> (8 * passes)) != 0) ++passes;

  std::vector<long long> tmp(static_cast<size_t>(n));
  long long* src = idx;
  long long* dst = tmp.data();
  long long count[256];
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    std::memset(count, 0, sizeof(count));
    for (long long i = 0; i < n; ++i)
      ++count[(keys[src[i]] >> shift) & 0xff];
    long long pos = 0;
    for (int b = 0; b < 256; ++b) {
      long long c = count[b];
      count[b] = pos;
      pos += c;
    }
    for (long long i = 0; i < n; ++i) {
      const uint64_t d = (keys[src[i]] >> shift) & 0xff;
      dst[count[d]++] = src[i];
    }
    long long* t = src;
    src = dst;
    dst = t;
  }
  if (src != idx) std::memcpy(idx, src, sizeof(long long) * n);
  return 0;
}

}  // extern "C"

#include <algorithm>
#include <unordered_map>

extern "C" {

// Segment-tile layout core (the host symbolic pass of
// ops/pallas_csr.py:build_seg_tiles), one O(nnz) sweep instead of global
// sorts + ~30 full-array NumPy passes.  Per R-row block (R = rows, a power
// of two; the original kernel uses 8, the 32-row super-block kernel 32):
// window/lane/sub decomposition anchored at the block's first lane-aligned
// column, spill tiers per (win, row, lane) collision, tiles numbered in
// (block, win, tier) order — bit-identical to the NumPy path (tests pin
// this; at R=8 also bit-identical to the pre-parameterized function).
//
// Outputs: pos[e] = tile*(R*128) + (row&(R-1))*128 + lane (one unique slot
// per entry), sub[e] in [0, wsub); per-tile seg_of (window base sublane)
// and t_rb (output row block).  Tile buffers must hold >= nnz entries.
// Returns the tile count, or -1 on bad arguments.
long long seg_tile_layout_r(const long long* indptr, long long n,
                            const long long* cols, long long wsub,
                            long long rows,
                            long long* pos, signed char* sub,
                            long long* seg_of, long long* t_rb) {
  if (n < 0 || wsub <= 0 || wsub > 127) return -1;
  if (rows <= 0 || (rows & (rows - 1)) != 0 || rows > 256) return -1;
  const long long R = rows;
  const long long slots = R * 128;
  long long n_tiles = 0;
  std::unordered_map<long long, int> tier_count;   // (win, ri, lane) -> seen
  std::unordered_map<long long, long long> tile_of_key;  // (win, tier) -> tile
  std::vector<long long> keys;  // unique (win, tier) keys of this block
  std::vector<long long> ewin, esub;  // per-entry win / tier-resolved data

  for (long long rb = 0; rb * R < n; ++rb) {
    const long long r0 = rb * R;
    const long long r1 = std::min(r0 + R, n);
    const long long s = indptr[r0], e = indptr[r1];
    if (s >= e) continue;
    // anchor: block's minimum column, lane-aligned (cols ascending per row,
    // so each row's first entry is its minimum)
    long long minc = cols[indptr[r0]];
    for (long long r = r0; r < r1; ++r)
      if (indptr[r] < indptr[r + 1]) minc = std::min(minc, cols[indptr[r]]);
    const long long anchor = minc >> 7;

    tier_count.clear();
    tile_of_key.clear();
    keys.clear();
    ewin.clear();
    esub.clear();
    // pass 1: tiers + unique (win, tier) keys
    for (long long r = r0; r < r1; ++r) {
      const long long ri = r & (R - 1);
      for (long long p = indptr[r]; p < indptr[r + 1]; ++p) {
        const long long c = cols[p];
        const long long q = c >> 7;
        const long long win = (q - anchor) / wsub;
        const long long lane = c & 127;
        const long long ck = win * slots + ri * 128 + lane;
        const int tier = tier_count[ck]++;
        const long long tk = (win << 24) + tier;  // tier < wsub * dup-count
        if (tile_of_key.emplace(tk, -1).second) keys.push_back(tk);
        ewin.push_back(tk);
        esub.push_back(q - anchor - win * wsub);
      }
    }
    std::sort(keys.begin(), keys.end());
    for (long long k : keys) {
      tile_of_key[k] = n_tiles;
      seg_of[n_tiles] = anchor + (k >> 24) * wsub;
      t_rb[n_tiles] = rb;
      ++n_tiles;
    }
    // pass 2: slot positions
    long long i = 0;
    for (long long r = r0; r < r1; ++r) {
      const long long ri = r & (R - 1);
      for (long long p = indptr[r]; p < indptr[r + 1]; ++p, ++i) {
        const long long c = cols[p];
        const long long tile = tile_of_key[ewin[i]];
        pos[p] = tile * slots + ri * 128 + (c & 127);
        sub[p] = static_cast<signed char>(esub[i]);
      }
    }
  }
  return n_tiles;
}

// Backward-compatible 8-row entry point (kept so the pinned bit-identity
// tests keep a stable symbol; delegates to the parameterized core).
long long seg_tile_layout(const long long* indptr, long long n,
                          const long long* cols, long long wsub,
                          long long* pos, signed char* sub,
                          long long* seg_of, long long* t_rb) {
  return seg_tile_layout_r(indptr, n, cols, wsub, 8, pos, sub, seg_of, t_rb);
}

// First-fit segment-tile layout: instead of the rigid anchor-partitioned
// windows of seg_tile_layout_r (where a block whose column span straddles a
// window boundary pays a second tile, and every (window, spill-tier) pair
// is its own tile), entries are placed greedily: per R-row block, entries
// are visited in (column, row) order and land in the FIRST open tile whose
// window still covers their column (tile base = its first entry's lane-
// aligned column) and whose (row, lane) slot is free; otherwise a new tile
// opens.  Measured on the 10M-nnz half-width-1000 band this cuts tiles
// ~25% vs the rigid layout at wsub=16 (straddle windows merge, spills
// pool across windows).  Same outputs/contract as seg_tile_layout_r,
// except within-tile entry order is column-major (callers re-sort by full
// slot position before the device fill).
long long seg_tile_layout_ff(const long long* indptr, long long n,
                             const long long* cols, long long wsub,
                             long long rows,
                             long long* pos, signed char* sub,
                             long long* seg_of, long long* t_rb) {
  if (n < 0 || wsub <= 0 || wsub > 127) return -1;
  if (rows <= 0 || (rows & (rows - 1)) != 0 || rows > 256) return -1;
  const long long R = rows;
  const long long slots = R * 128;
  const int words = static_cast<int>(slots / 64);
  long long n_tiles = 0;
  std::vector<std::pair<long long, long long>> ents;  // (col<<32|ri, p)
  std::vector<long long> open_base;   // per open tile: window base sublane
  std::vector<long long> open_id;     // per open tile: global tile id
  std::vector<uint64_t> open_bits;    // per open tile: words x u64 bitmap

  for (long long rb = 0; rb * R < n; ++rb) {
    const long long r0 = rb * R;
    const long long r1 = std::min(r0 + R, n);
    if (indptr[r0] >= indptr[r1]) continue;
    ents.clear();
    for (long long r = r0; r < r1; ++r) {
      const long long ri = r & (R - 1);
      for (long long p = indptr[r]; p < indptr[r + 1]; ++p)
        ents.emplace_back((cols[p] << 8) | ri, p);
    }
    std::sort(ents.begin(), ents.end());
    open_base.clear();
    open_id.clear();
    open_bits.clear();
    for (const auto& e : ents) {
      const long long c = e.first >> 8;
      const long long ri = e.first & 0xff;
      const long long p = e.second;
      const long long q = c >> 7;
      const long long lane = c & 127;
      const long long slot = ri * 128 + lane;
      const int w = static_cast<int>(slot >> 6);
      const uint64_t bit = uint64_t{1} << (slot & 63);
      long long chosen = -1;
      for (size_t ti = 0; ti < open_base.size(); ++ti) {
        if (q - open_base[ti] >= wsub) continue;  // window passed (q >= base)
        if (open_bits[ti * words + w] & bit) continue;  // slot taken
        chosen = static_cast<long long>(ti);
        break;
      }
      if (chosen < 0) {
        chosen = static_cast<long long>(open_base.size());
        open_base.push_back(q);
        open_id.push_back(n_tiles);
        open_bits.resize(open_bits.size() + words, 0);
        seg_of[n_tiles] = q;
        t_rb[n_tiles] = rb;
        ++n_tiles;
      }
      open_bits[chosen * words + w] |= bit;
      pos[p] = open_id[chosen] * slots + slot;
      sub[p] = static_cast<signed char>(q - open_base[chosen]);
    }
  }
  return n_tiles;
}

// Stable counting argsort by small integer keys (one count + one placement
// pass — ~4x fewer array sweeps than the byte-wise radix when keys are
// already bucket-sized, e.g. segment-tile ids).  Returns 0 on success,
// nonzero when a key falls outside [0, nbuckets).
long long counting_argsort_i64(const long long* keys, long long n,
                               long long nbuckets, long long* idx) {
  if (n < 0 || nbuckets <= 0 || (n > 0 && (!keys || !idx))) return 1;
  std::vector<long long> count(static_cast<size_t>(nbuckets) + 1, 0);
  for (long long i = 0; i < n; ++i) {
    const long long k = keys[i];
    if (k < 0 || k >= nbuckets) return 2;
    ++count[k];
  }
  long long at = 0;
  for (long long b = 0; b < nbuckets; ++b) {
    const long long c = count[b];
    count[b] = at;
    at += c;
  }
  for (long long i = 0; i < n; ++i) idx[count[keys[i]]++] = i;
  return 0;
}

}  // extern "C"

extern "C" {

// SpGEMM product schedule (the symbolic pass of ops/spgemm.py:
// spgemm_prepare): enumerate every scalar product (A entry x matching
// prepared-B entry), sort by output coordinate (row-major), and emit the
// packed schedule + output CSR structure.  One enumeration pass + one
// radix argsort + one emission pass, all O(F).
//
// Inputs: A's row pointer/indices (valid entries packed first), prepared
// B's per-row starts (b_starts, length m+1), per-position output column
// (b_cols) and original storage position (b_src).  F = caller-computed
// product count.  Outputs (length F): a_pos/b_pos/seg in output order;
// out_rows/out_cols hold the nse_out unique coordinates.
// Returns nse_out, or -1 on bad arguments.
long long spgemm_schedule(const long long* a_indptr, long long n,
                          const long long* a_indices,
                          const long long* b_starts, long long m,
                          const long long* b_cols, const long long* b_src,
                          long long k, long long F,
                          long long* a_pos, long long* b_pos, long long* seg,
                          long long* out_rows, long long* out_cols) {
  if (n < 0 || m < 0 || k < 0 || F < 0) return -1;
  std::vector<uint64_t> key(static_cast<size_t>(F));
  long long f = 0;
  const uint64_t kw = static_cast<uint64_t>(k) + 1;
  for (long long r = 0; r < n; ++r) {
    for (long long p = a_indptr[r]; p < a_indptr[r + 1]; ++p) {
      const long long s = a_indices[p];
      if (s < 0 || s >= m) return -1;
      for (long long q = b_starts[s]; q < b_starts[s + 1]; ++q) {
        if (f >= F) return -1;
        key[f] = static_cast<uint64_t>(r) * kw +
                 static_cast<uint64_t>(b_cols[q]);
        a_pos[f] = p;
        b_pos[f] = b_src[q];
        ++f;
      }
    }
  }
  if (f != F) return -1;
  std::vector<long long> order(static_cast<size_t>(F));
  if (radix_argsort_u64(key.data(), F, order.data()) != 0) return -1;
  // emit in sorted order, reusing seg as scratch is not possible (outputs
  // alias nothing); permute via gather into temporaries
  std::vector<long long> ta(static_cast<size_t>(F)), tb(static_cast<size_t>(F));
  for (long long i = 0; i < F; ++i) {
    ta[i] = a_pos[order[i]];
    tb[i] = b_pos[order[i]];
  }
  std::memcpy(a_pos, ta.data(), sizeof(long long) * F);
  std::memcpy(b_pos, tb.data(), sizeof(long long) * F);
  long long nse = 0;
  uint64_t prev = ~uint64_t{0};
  for (long long i = 0; i < F; ++i) {
    const uint64_t kk = key[order[i]];
    if (i == 0 || kk != prev) {
      out_rows[nse] = static_cast<long long>(kk / kw);
      out_cols[nse] = static_cast<long long>(kk % kw);
      ++nse;
      prev = kk;
    }
    seg[i] = nse - 1;
  }
  return nse;
}

}  // extern "C"

extern "C" {

// Reverse Cuthill-McKee ordering on the symmetrized pattern (A + A^T).
// The classic bandwidth-reducing permutation: BFS per connected component
// from a minimum-degree seed, frontier neighbours appended in ascending
// symmetrized-degree order (stable over ascending node id), whole order
// reversed at the end.  Matches SciPy's reverse_cuthill_mckee semantics
// (component seed = first unvisited minimum-degree node; per-node stable
// degree sort).  Self-loops and reciprocal duplicates are deduplicated.
//
// Inputs: CSR pattern indptr [n+1] / cols [nnz] of an n x n matrix (column
// order within a row does not matter).  Output: perm [n] with perm[k] = the
// OLD index placed at NEW position k, i.e. A[perm][:, perm] is banded.
// Returns 0 on success, -1 on bad arguments.
long long rcm_order(const long long* indptr, long long n,
                    const long long* cols, long long* perm) {
  if (n < 0 || (n > 0 && (!indptr || !perm))) return -1;
  if (n == 0) return 0;
  const long long nnz = indptr[n];
  if (nnz < 0 || (nnz > 0 && !cols)) return -1;

  // symmetrize + dedup: emit (i,j) and (j,i) per entry, radix sort fused
  // u64 keys, unique.
  std::vector<uint64_t> keys;
  keys.reserve(static_cast<size_t>(2 * nnz));
  const uint64_t un = static_cast<uint64_t>(n);
  for (long long i = 0; i < n; ++i) {
    for (long long p = indptr[i]; p < indptr[i + 1]; ++p) {
      const long long j = cols[p];
      if (j < 0 || j >= n) return -1;
      if (j == static_cast<long long>(i)) continue;  // self-loops: no edge
      keys.push_back(static_cast<uint64_t>(i) * un + static_cast<uint64_t>(j));
      keys.push_back(static_cast<uint64_t>(j) * un + static_cast<uint64_t>(i));
    }
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  const long long ne = static_cast<long long>(keys.size());

  std::vector<long long> adj_ptr(static_cast<size_t>(n) + 1, 0);
  std::vector<long long> adj(static_cast<size_t>(ne));
  for (long long e = 0; e < ne; ++e)
    ++adj_ptr[keys[e] / un + 1];
  for (long long i = 0; i < n; ++i) adj_ptr[i + 1] += adj_ptr[i];
  for (long long e = 0; e < ne; ++e)
    adj[e] = static_cast<long long>(keys[e] % un);  // sorted keys: rows
                                                    // grouped, cols ascending

  std::vector<long long> deg(static_cast<size_t>(n));
  for (long long i = 0; i < n; ++i) deg[i] = adj_ptr[i + 1] - adj_ptr[i];

  std::vector<unsigned char> visited(static_cast<size_t>(n), 0);
  std::vector<std::pair<long long, long long>> nbr;  // (degree, node)
  long long head = 0, tail = 0;   // perm doubles as the BFS queue
  long long seed_scan = 0;        // nodes before this are all visited
  while (tail < n) {
    // next component: first unvisited minimum-degree node
    while (visited[seed_scan]) ++seed_scan;
    long long seed = seed_scan;
    for (long long i = seed_scan + 1; i < n; ++i)
      if (!visited[i] && deg[i] < deg[seed]) seed = i;
    visited[seed] = 1;
    perm[tail++] = seed;
    while (head < tail) {
      const long long u = perm[head++];
      nbr.clear();
      for (long long p = adj_ptr[u]; p < adj_ptr[u + 1]; ++p) {
        const long long v = adj[p];
        if (!visited[v]) {
          visited[v] = 1;
          nbr.emplace_back(deg[v], v);
        }
      }
      std::stable_sort(nbr.begin(), nbr.end(),
                       [](const std::pair<long long, long long>& a,
                          const std::pair<long long, long long>& b) {
                         return a.first < b.first;
                       });
      for (const auto& dv : nbr) perm[tail++] = dv.second;
    }
  }
  // reverse
  for (long long i = 0, j = n - 1; i < j; ++i, --j) {
    const long long t = perm[i];
    perm[i] = perm[j];
    perm[j] = t;
  }
  return 0;
}

}  // extern "C"
