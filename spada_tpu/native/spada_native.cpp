// Native host-side components (C++17, no external deps).
//
// The reference implements its whole host runtime natively (Rust); these are
// the rebuild's native equivalents for the two host-side hot paths:
//
//  1. mtx_parse_body — MatrixMarket coordinate-body parsing (the reference
//     shells into scipy via pyo3, py2rust.rs:62-97; here a single-pass
//     strtoll/strtod tokenizer, much faster than numpy text splitting).
//  2. traffic_simulate — the functional traffic model's fiber-cache walk
//     (models/traffic.py semantics; reference storage.rs:460-1007): the
//     reference-exact priority cache — min-heap of [priority, addr] with
//     lazy invalidation, priority = A-traversal position of the most recent
//     access (psum rows: their own address) — and reference-exact word
//     counters, for the default full-K row-wise schedule (one psum per row;
//     the windowed merge path stays in Python).
//  3. esc_plan — the element path's symbolic phase (ops/element.py).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <queue>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. MatrixMarket coordinate-body parser
// ---------------------------------------------------------------------------
// Parses `nnz` entries of "row col [val]" (1-based) from text[0:len] into
// caller-allocated arrays.  Returns entries parsed (< nnz on malformed
// input).  field_pattern != 0: no value column (pattern matrices -> 1.0).
int64_t mtx_parse_body(const char* text, int64_t len, int64_t nnz,
                       int field_pattern, int64_t* rows, int64_t* cols,
                       double* vals) {
    const char* p = text;
    const char* end = text + len;
    int64_t n = 0;
    auto skip_ws = [&]() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r')) ++p;
    };
    auto parse_int = [&](int64_t* out) -> bool {
        skip_ws();
        if (p >= end) return false;
        char* q;
        long long v = strtoll(p, &q, 10);
        if (q == p) return false;
        p = q;
        *out = (int64_t)v;
        return true;
    };
    auto parse_f = [&](double* out) -> bool {
        skip_ws();
        if (p >= end) return false;
        char* q;
        double v = strtod(p, &q);
        if (q == p) return false;
        p = q;
        *out = v;
        return true;
    };
    while (n < nnz) {
        int64_t r, c;
        if (!parse_int(&r) || !parse_int(&c)) break;
        double v = 1.0;
        if (!field_pattern && !parse_f(&v)) break;
        rows[n] = r - 1;
        cols[n] = c - 1;
        vals[n] = v;
        ++n;
    }
    return n;
}

// ---------------------------------------------------------------------------
// 2. Functional traffic model cache walk (full-K rows, one psum per row)
// ---------------------------------------------------------------------------
// Counter semantics (see models/traffic.py for the file:line citations):
//   row of L elements = 2L words; scalar read = 2 words; B rows clean-drop
//   on eviction, psum rows write back to DRAM.  Eviction is the reference's
//   policy (LatencyPriorityCache, storage.rs:546-658): pop the MINIMUM
//   [priority, addr] from a lazily-invalidated heap, where priority is the
//   A-traversal position of the row's most recent access (psum rows: their
//   own address, which sits above output_base = b_rows + 1).  Miss fills
//   count miss + cache_write but NOT cache_read (storage.rs:792-818).
//
// Inputs: A's CSR structure, B row lengths, traversal order, per-traversed-
// row merged-psum nnz (row_psum_nnz[i] for row_order[i], computed in numpy).
// Output counters (out[15]):
//   0 a_mem_read    1 b_mem_read     2 psum_mem_read  3 psum_mem_write
//   4 miss          5 b_evict        6 psum_evict     7 b_touched
//   8 b_distinct    9 c_touched     10 cache_read    11 cache_write
//  12 c_final      13 max_occupancy 14 fill_count

struct HeapEnt {
    int64_t prio;
    int64_t addr;
    // std::priority_queue is a max-heap; invert to pop the MINIMUM
    // [prio, addr] like the reference's BinaryHeap<Reverse<[usize;2]>>.
    bool operator<(const HeapEnt& o) const {
        if (prio != o.prio) return prio > o.prio;
        return addr > o.addr;
    }
};

// Per-row (= per full-K window) task components for the latency
// accumulation (models/traffic.py windowed_cycles): row_traffic = DRAM
// words moved by the window (A read + B fills + evict write-backs, the
// final swapout excluded to match the Python model's snapshot span) and
// row_fills = B fill events.  Null pointers skip the collection.
int traffic_simulate(const int64_t* a_indptr, const int32_t* a_indices,
                     int64_t a_rows, const int64_t* b_row_lens,
                     int64_t b_rows, const int64_t* row_order,
                     int64_t capacity_words, const int64_t* row_psum_nnz,
                     int64_t* out, int64_t* row_traffic,
                     int64_t* row_fills) {
    for (int i = 0; i < 15; ++i) out[i] = 0;
    int64_t& a_read = out[0];
    int64_t& b_read = out[1];
    int64_t& psum_write = out[3];
    int64_t& miss = out[4];
    int64_t& b_evict = out[5];
    int64_t& p_evict = out[6];
    int64_t& b_touched = out[7];
    int64_t& b_distinct = out[8];
    int64_t& c_touched = out[9];
    int64_t& cache_read = out[10];
    int64_t& cache_write = out[11];
    int64_t& c_final = out[12];
    int64_t& max_occ = out[13];
    int64_t& fills = out[14];

    const int64_t output_base = b_rows + 1;  // psum addr space (main.rs:65)
    std::unordered_map<int64_t, int64_t> resident;  // addr -> words
    std::unordered_map<int64_t, int64_t> prio;      // valid_pq_row_dict
    std::priority_queue<HeapEnt> heap;
    int64_t occ = 0, b_occ = 0;
    std::vector<char> b_seen((size_t)b_rows, 0);

    auto bump = [&](int64_t addr, int64_t p) {
        auto it = prio.find(addr);
        int64_t np_ = (it == prio.end()) ? p : std::max(it->second, p);
        prio[addr] = np_;
        heap.push({np_, addr});
    };

    auto insert = [&](int64_t addr, int64_t words, int64_t p) {
        // freeup_space (storage.rs:599-658)
        while (occ + words > capacity_words) {
            int64_t victim = -1;
            if (b_occ < words) {
                // resident B rows can't cover it: take the lowest-addr psum
                // (storage.rs:603-611; reference takes HashMap order)
                int64_t best = INT64_MAX;
                for (const auto& kv : resident)
                    if (kv.first >= output_base && kv.first != addr &&
                        kv.first < best)
                        best = kv.first;
                if (best != INT64_MAX) victim = best;
            }
            if (victim < 0) {
                while (!heap.empty()) {
                    HeapEnt e = heap.top();
                    heap.pop();
                    auto it = resident.find(e.addr);
                    if (it == resident.end()) continue;          // stale
                    auto pit = prio.find(e.addr);
                    if (pit == prio.end() || pit->second != e.prio) continue;
                    if (e.addr == addr) continue;   // pinned (self)
                    victim = e.addr;
                    break;
                }
            }
            if (victim < 0) return;  // nothing evictable: stream (no panic)
            int64_t w = resident[victim];
            occ -= w;
            resident.erase(victim);
            if (victim < output_base) {
                b_occ -= w;
                b_evict += w;        // clean drop
            } else {
                p_evict += w;
                psum_write += w;     // write-back
            }
        }
        if (occ + words <= capacity_words) {
            resident[addr] = words;
            occ += words;
            if (addr < output_base) b_occ += words;
            bump(addr, p);
            if (occ > max_occ) max_occ = occ;
        }
    };

    int64_t psum_uid = 0;
    for (int64_t i = 0; i < a_rows; ++i) {
        int64_t r = row_order[i];
        int64_t s = a_indptr[r], e = a_indptr[r + 1];
        if (row_traffic) { row_traffic[i] = 0; }
        if (row_fills) { row_fills[i] = 0; }
        if (e == s) continue;
        const int64_t dram0 = a_read + b_read + psum_write;
        const int64_t fills0 = fills;
        a_read += 2 * (e - s);
        for (int64_t j = s; j < e; ++j) {
            int64_t k = (int64_t)a_indices[j];
            int64_t words = 2 * b_row_lens[k];
            if (!words) continue;
            b_touched += words;
            if (!b_seen[(size_t)k]) {
                b_seen[(size_t)k] = 1;
                b_distinct += words;
            }
            if (resident.count(k)) {
                cache_read += words;   // hit readout (storage.rs:775-791)
                bump(k, i);
            } else {
                b_read += words;       // DRAM fill; readout NOT a cache read
                miss += words;
                ++fills;
                cache_write += words;
                insert(k, words, i);
            }
        }
        int64_t pw = 2 * row_psum_nnz[i];
        if (pw) {
            c_touched += pw;
            cache_write += pw;
            int64_t addr = output_base + psum_uid++;
            insert(addr, pw, addr);  // fresh psum prio = its own address
            // window task snapshot: after the psum insert's evictions,
            // before the swapout write (matches the Python model)
            if (row_traffic)
                row_traffic[i] = (a_read + b_read + psum_write) - dram0;
            if (row_fills) row_fills[i] = fills - fills0;
            // finished row: swap out to DRAM immediately
            auto it = resident.find(addr);
            if (it != resident.end()) {
                occ -= it->second;
                resident.erase(it);
            }
            psum_write += pw;
            c_final += pw;
        }
    }
    return 0;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// 3. ESC plan builder (ops/element.py, native for large expansions)
// ---------------------------------------------------------------------------
// The element-granular symbolic phase: expand every scalar product
// a[r,k]*b[k,j] (the reference scheduler's window expansion,
// scheduler.rs:482-606), merge-sort products by output element (the
// SortingNetwork/MergeTree of simulator.rs:117-235, resolved at plan time),
// split segments into <=cap chunks and bucket them by power-of-two length
// class.  Single pass per row with a per-row sort — the global key sort of
// the numpy fallback is unnecessary because the row-major expansion already
// groups products by output row.
//
// Outputs (caller-allocated; E = total products, known in closed form):
//   counts[6]     : nnzC, total_chunks, n_padded, n_classes, max_class, E
//   c_indices[E]  : column of each output nonzero (CSR order)
//   c_row_counts[m]: nonzeros of C per row
//   class_L[32], class_n[32]
//   esc_to_csr[E + E/cap + 2] : segment id per chunk, class-grouped order
//   ag, bg[2E + 64]           : flat class-grouped padded operand indices
//                               (sentinels nnz_a / nnz_b)
// Returns 0, or -1 on allocation failure.
int esc_plan(const int64_t* a_indptr, const int32_t* a_indices, int64_t m,
             const int64_t* b_indptr, const int32_t* b_indices,
             int64_t b_rows, int64_t cap,
             int64_t* counts, int32_t* c_indices, int32_t* c_row_counts,
             int32_t* class_L, int64_t* class_n, int32_t* esc_to_csr,
             int32_t* ag, int32_t* bg) {
    const int64_t nnz_a = a_indptr[m];
    const int64_t nnz_b = b_indptr[b_rows];
    int log_cap = 0;
    while ((int64_t(1) << log_cap) < cap) ++log_cap;
    const int n_classes_max = log_cap + 1;   // L = 1, 2, ..., cap
    if (n_classes_max > 32) return -1;

    // total products E
    int64_t E = 0;
    for (int64_t i = 0; i < nnz_a; ++i) {
        int32_t k = a_indices[i];
        E += b_indptr[k + 1] - b_indptr[k];
    }

    // merged-order product operand indices + chunk metadata
    std::vector<int32_t> s_ae, s_be;
    std::vector<int64_t> ch_start;
    std::vector<int32_t> ch_len, ch_seg;
    std::vector<int8_t> ch_cls;
    try {
        s_ae.resize((size_t)E);
        s_be.resize((size_t)E);
    } catch (...) { return -1; }

    struct Trip { int32_t col, ae; int32_t be; };
    std::vector<uint64_t> keys;   // col<<32 | scratch idx (stable per-row)
    std::vector<Trip> scratch;

    int64_t pos = 0;       // write position in merged order
    int64_t nnz_c = 0;
    int64_t class_hist[32] = {0};

    for (int64_t r = 0; r < m; ++r) {
        c_row_counts[r] = 0;
        // expand row r
        scratch.clear();
        for (int64_t i = a_indptr[r]; i < a_indptr[r + 1]; ++i) {
            int32_t k = a_indices[i];
            for (int64_t j = b_indptr[k]; j < b_indptr[k + 1]; ++j)
                scratch.push_back({b_indices[j], (int32_t)i, (int32_t)j});
        }
        const size_t nr = scratch.size();
        if (!nr) continue;
        if (nr > (size_t)UINT32_MAX) return -1;  // key packing limit
        keys.resize(nr);
        for (size_t t = 0; t < nr; ++t)
            keys[t] = ((uint64_t)(uint32_t)scratch[t].col << 32) | (uint32_t)t;
        std::sort(keys.begin(), keys.end());
        // walk sorted: segments by column, chunks of <=cap
        size_t t = 0;
        while (t < nr) {
            int32_t col = (int32_t)(keys[t] >> 32);
            size_t seg_end = t;
            while (seg_end < nr && (int32_t)(keys[seg_end] >> 32) == col)
                ++seg_end;
            c_indices[nnz_c] = col;
            ++c_row_counts[r];
            size_t len = seg_end - t;
            for (size_t off = 0; off < len; off += (size_t)cap) {
                int32_t clen = (int32_t)std::min((size_t)cap, len - off);
                int cls = 0;
                while ((1 << cls) < clen) ++cls;
                ch_start.push_back(pos + (int64_t)t + (int64_t)off);
                ch_len.push_back(clen);
                ch_seg.push_back((int32_t)nnz_c);
                ch_cls.push_back((int8_t)cls);
                ++class_hist[cls];
            }
            ++nnz_c;
            t = seg_end;
        }
        for (size_t q = 0; q < nr; ++q) {
            const Trip& tr = scratch[(uint32_t)keys[q]];
            s_ae[(size_t)(pos + (int64_t)q)] = tr.ae;
            s_be[(size_t)(pos + (int64_t)q)] = tr.be;
        }
        pos += (int64_t)nr;
    }

    // class layout: slot offsets in the flat padded arrays + chunk offsets
    int n_classes = 0;
    int64_t class_slot_base[33] = {0};   // padded-slot base per class
    int64_t class_chunk_base[33] = {0};  // chunk-count base per class
    int cls_id_of[32];
    int64_t n_padded = 0, total_chunks = 0;
    for (int c = 0; c < n_classes_max; ++c) {
        if (!class_hist[c]) { cls_id_of[c] = -1; continue; }
        cls_id_of[c] = n_classes;
        class_L[n_classes] = 1 << c;
        class_n[n_classes] = class_hist[c];
        class_slot_base[n_classes] = n_padded;
        class_chunk_base[n_classes] = total_chunks;
        n_padded += class_hist[c] * (int64_t(1) << c);
        total_chunks += class_hist[c];
        ++n_classes;
    }
    // fill class-grouped padded operands + esc_to_csr
    std::vector<int64_t> class_fill(n_classes, 0);
    for (size_t ci = 0; ci < ch_start.size(); ++ci) {
        int cid = cls_id_of[(int)ch_cls[ci]];
        int64_t L = (int64_t)class_L[cid];
        int64_t slot = class_fill[cid]++;
        int64_t dst = class_slot_base[cid] + slot * L;
        int64_t src = ch_start[ci];
        int32_t len = ch_len[ci];
        for (int32_t q = 0; q < len; ++q) {
            ag[dst + q] = s_ae[(size_t)(src + q)];
            bg[dst + q] = s_be[(size_t)(src + q)];
        }
        for (int64_t q = len; q < L; ++q) {
            ag[dst + q] = (int32_t)nnz_a;
            bg[dst + q] = (int32_t)nnz_b;
        }
        esc_to_csr[class_chunk_base[cid] + slot] = ch_seg[ci];
    }

    counts[0] = nnz_c;
    counts[1] = total_chunks;
    counts[2] = n_padded;
    counts[3] = n_classes;
    counts[4] = int64_t(1) << log_cap;
    counts[5] = E;
    return 0;
}

}  // extern "C"
