// Continuous-batching scheduler — native host core of the generation
// engine (vLLM's scheduler's analogue), the port's copy of
// distllm_tpu/native/scheduler.cpp, built with g++ at first use.
//
// Owns ALL scheduling state: the block free-list, per-request block lists,
// slot assignment, the waiting queue, and the admission / recompute-
// preemption policy. The Python engine asks it what to do each step and
// only runs the device programs. A pure-Python twin
// (engine/scheduler.py PyScheduler) implements the identical policy;
// differential tests drive both with the same workload and require
// identical decisions.
//
// Policy (must stay in lockstep with PyScheduler):
//   - admit_next: pop the head of the waiting queue into the lowest free
//     slot if blocks for (num_tokens + 1) are available.
//   - prepare_decode(k): every running sequence gets capacity for k more
//     tokens (k > 1 backs the engine's multi-step fused decode windows,
//     where K tokens are generated per dispatch); on OOM, preempt the
//     youngest (highest request id) running request — free its blocks,
//     push it to the FRONT of the waiting queue (recompute preemption: it
//     will re-prefill prompt + generated). The rows_k variant grants
//     PER-ROW headroom (speculative verify windows reserve each row's
//     own 1 + draft span rather than the batch max).
//   - trim(rid): return owned tail blocks beyond blocks_needed(num_tokens
//     + 1) to the free list, newest first (LIFO restore) — the rejected-
//     suffix rollback of speculative windows.
//   - block 0 is the reserved trash block and is never handed out.
//   - borrowed prefixes (automatic prefix caching): the first
//     `num_borrowed` blocks of a request's row are prefix-cache property —
//     attached at add (cache hit) or marked via sched_lend_prefix (freshly
//     prefilled prompt blocks adopted by the cache). They are never
//     returned to the free list here (finish/preemption free only the
//     owned tail; the cache hands evicted blocks back through
//     sched_release_blocks), they survive recompute preemption, and they
//     count toward the admission block budget (only the shortfall is
//     allocated).
//
// C ABI for ctypes; no exceptions across the boundary.

#include <algorithm>
#include <cstdint>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
    int64_t rid;
    int32_t num_tokens;  // prompt + generated so far
    std::vector<int32_t> blocks;
    int32_t slot = -1;  // -1 = not running
    int32_t num_borrowed = 0;  // leading cache-owned blocks (never freed)
};

struct Scheduler {
    int32_t block_size;
    std::vector<int32_t> free_list;  // LIFO of free block ids (block 0 reserved)
    std::deque<int64_t> waiting;
    std::vector<int64_t> slots;  // slot -> rid, -1 empty
    std::unordered_map<int64_t, Request> requests;

    Scheduler(int32_t num_blocks, int32_t block_size_, int32_t max_num_seqs)
        : block_size(block_size_), slots(max_num_seqs, -1) {
        free_list.reserve(num_blocks > 0 ? num_blocks - 1 : 0);
        for (int32_t i = num_blocks - 1; i >= 1; --i) free_list.push_back(i);
    }

    int32_t blocks_needed(int32_t tokens) const {
        return (tokens + block_size - 1) / block_size;
    }

    int32_t num_free() const {
        return static_cast<int32_t>(free_list.size());
    }

    int32_t alloc_block() {
        if (free_list.empty()) return -1;
        int32_t b = free_list.back();
        free_list.pop_back();
        return b;
    }

    // Free the OWNED tail of a request's row; the borrowed prefix stays
    // (prefix-cache property — see the policy note above).
    void free_request_blocks(Request& req) {
        for (size_t i = req.num_borrowed; i < req.blocks.size(); ++i)
            free_list.push_back(req.blocks[i]);
        req.blocks.resize(req.num_borrowed);
    }

    int32_t free_slot() const {
        for (size_t i = 0; i < slots.size(); ++i)
            if (slots[i] < 0) return static_cast<int32_t>(i);
        return -1;
    }

    int32_t num_running() const {
        int32_t n = 0;
        for (int64_t rid : slots) n += (rid >= 0);
        return n;
    }

    // Grow req.blocks to cover `tokens`; false = pool dry (partial growth
    // is kept — the caller retries after preempting someone).
    bool extend(Request& req, int32_t tokens) {
        while (static_cast<int32_t>(req.blocks.size()) < blocks_needed(tokens)) {
            int32_t b = alloc_block();
            if (b < 0) return false;
            req.blocks.push_back(b);
        }
        return true;
    }

    // Preempt the youngest (max rid) running request. Returns its rid, or
    // -1 when fewer than two are running (never preempt the only one).
    int64_t preempt_youngest() {
        int64_t victim = -1;
        int32_t count = 0;
        for (int64_t rid : slots) {
            if (rid < 0) continue;
            ++count;
            victim = std::max(victim, rid);
        }
        if (count <= 1) return -1;
        Request& req = requests[victim];
        free_request_blocks(req);
        slots[req.slot] = -1;
        req.slot = -1;
        waiting.push_front(victim);
        return victim;
    }
};

}  // namespace

extern "C" {

void* sched_create(int32_t num_blocks, int32_t block_size,
                   int32_t max_num_seqs) {
    if (num_blocks < 2 || block_size < 1 || max_num_seqs < 1) return nullptr;
    return new Scheduler(num_blocks, block_size, max_num_seqs);
}

void sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

// Enqueue a request with `num_tokens` tokens to recompute (prompt, plus any
// generated tokens when re-adding after an external preemption). Returns 0,
// or -1 if it can never fit even in an empty pool.
int32_t sched_add(void* h, int64_t rid, int32_t num_tokens) {
    auto* s = static_cast<Scheduler*>(h);
    if (s->requests.count(rid)) return -2;
    Request req;
    req.rid = rid;
    req.num_tokens = num_tokens;
    s->requests.emplace(rid, std::move(req));
    s->waiting.push_back(rid);
    return 0;
}

// sched_add with a borrowed prefix: `cached[0..n_cached)` are prefix-cache
// blocks covering the request's first n_cached * block_size tokens. They
// join the row immediately and count toward the admission budget.
int32_t sched_add_cached(void* h, int64_t rid, int32_t num_tokens,
                         const int32_t* cached, int32_t n_cached) {
    auto* s = static_cast<Scheduler*>(h);
    if (s->requests.count(rid)) return -2;
    if (n_cached < 0) return -3;
    Request req;
    req.rid = rid;
    req.num_tokens = num_tokens;
    req.blocks.assign(cached, cached + n_cached);
    req.num_borrowed = n_cached;
    s->requests.emplace(rid, std::move(req));
    s->waiting.push_back(rid);
    return 0;
}

// Admit the head of the waiting queue: assign the lowest free slot and
// allocate blocks for num_tokens + 1. Returns the admitted rid, -1 when
// nothing can be admitted right now, or -2 when the head request cannot get
// blocks while NOTHING is running (caller should raise: pool too small).
int64_t sched_admit_next(void* h) {
    auto* s = static_cast<Scheduler*>(h);
    if (s->waiting.empty()) return -1;
    int32_t slot = s->free_slot();
    if (slot < 0) return -1;
    int64_t rid = s->waiting.front();
    Request& req = s->requests[rid];
    // Blocks already on the row (borrowed prefix) cover part of the
    // budget; only the shortfall is allocated.
    int32_t shortfall = s->blocks_needed(req.num_tokens + 1) -
                        static_cast<int32_t>(req.blocks.size());
    if (shortfall > s->num_free()) {
        return s->num_running() == 0 ? -2 : -1;
    }
    s->waiting.pop_front();
    for (int32_t i = 0; i < shortfall; ++i) req.blocks.push_back(s->alloc_block());
    req.slot = slot;
    s->slots[slot] = rid;
    return rid;
}

// Ensure every running sequence has block capacity for `k` more tokens,
// preempting the youngest on OOM. Preempted rids are written to
// out_preempted (capacity = max_num_seqs). Returns the preempted count, or
// -(1 + n_preempted) when the pool is exhausted with a single running
// sequence (fatal) — preemptions already performed in this call are NOT
// rolled back (their requests sit in the waiting queue), so the caller must
// read out_preempted[0..n_preempted) and sync its request states before
// raising.
// Row-filtered variant (mixed prefill+decode serving windows): only the
// `n_rids` requests listed in `rids` are extended by k. Rows mid-prefill
// inside a mixed window already own blocks for their full prompt from
// admission, so giving them speculative decode headroom would waste pool
// and provoke spurious preemptions. Preemption victims are still chosen
// youngest-first over ALL running rows (a mid-prefill row may be
// recompute-preempted; the engine resets its chunk progress).
// rids == nullptr means "all running rows" (the classic policy).
// ks (nullable, parallel to rids) overrides k per row: speculative verify
// windows reserve each row's own 1 + draft span instead of the batch max.
int32_t sched_prepare_decode_rows_k(void* h, int32_t k, const int64_t* rids,
                                    const int32_t* ks, int32_t n_rids,
                                    int64_t* out_preempted) {
    auto* s = static_cast<Scheduler*>(h);
    // INT32_MIN = argument error; must not collide with the fatal-
    // exhaustion encoding -(1 + n_preempted).
    if (k < 1 || n_rids < 0) return INT32_MIN;
    if (ks != nullptr) {
        if (rids == nullptr) return INT32_MIN;
        for (int32_t i = 0; i < n_rids; ++i) {
            if (ks[i] < 1) return INT32_MIN;
            // Duplicate rids would make the per-row k ambiguous (and
            // first-wins here vs last-wins in the Python twin's dict
            // would silently break lockstep parity): argument error.
            for (int32_t j = 0; j < i; ++j)
                if (rids[j] == rids[i]) return INT32_MIN;
        }
    }
    int32_t n_preempted = 0;
    std::vector<int64_t> snapshot(s->slots);
    for (int64_t rid : snapshot) {
        if (rid < 0) continue;
        int32_t k_row = k;
        if (rids != nullptr) {
            const int64_t* hit = std::find(rids, rids + n_rids, rid);
            if (hit == rids + n_rids)
                continue;  // not selected for decode this window
            if (ks != nullptr) k_row = ks[hit - rids];
        }
        Request& req = s->requests[rid];
        if (req.slot < 0) continue;  // preempted earlier in this loop
        bool preempted_self = false;
        while (!s->extend(req, req.num_tokens + k_row)) {
            int64_t victim = s->preempt_youngest();
            if (victim < 0) return -(1 + n_preempted);
            out_preempted[n_preempted++] = victim;
            if (victim == rid) {
                preempted_self = true;
                break;
            }
        }
        if (preempted_self) continue;
    }
    return n_preempted;
}

int32_t sched_prepare_decode_rows(void* h, int32_t k, const int64_t* rids,
                                  int32_t n_rids, int64_t* out_preempted) {
    return sched_prepare_decode_rows_k(h, k, rids, nullptr, n_rids,
                                       out_preempted);
}

int32_t sched_prepare_decode_k(void* h, int32_t k, int64_t* out_preempted) {
    return sched_prepare_decode_rows_k(h, k, nullptr, nullptr, 0,
                                       out_preempted);
}

// Free owned tail blocks beyond blocks_needed(num_tokens + 1), newest
// first so the LIFO free list is restored to its pre-reservation state (a
// later extension re-pops the identical blocks). Borrowed prefix blocks
// are never touched. Returns the count freed, or -1 for an unknown rid.
int32_t sched_trim(void* h, int64_t rid) {
    auto* s = static_cast<Scheduler*>(h);
    auto it = s->requests.find(rid);
    if (it == s->requests.end()) return -1;
    Request& req = it->second;
    int32_t keep = std::max(s->blocks_needed(req.num_tokens + 1),
                            req.num_borrowed);
    int32_t freed = static_cast<int32_t>(req.blocks.size()) - keep;
    if (freed <= 0) return 0;
    for (int32_t i = static_cast<int32_t>(req.blocks.size()) - 1; i >= keep;
         --i)
        s->free_list.push_back(req.blocks[i]);
    req.blocks.resize(keep);
    return freed;
}

int32_t sched_prepare_decode(void* h, int64_t* out_preempted) {
    return sched_prepare_decode_k(h, 1, out_preempted);
}

int32_t sched_append_token(void* h, int64_t rid) {
    auto* s = static_cast<Scheduler*>(h);
    auto it = s->requests.find(rid);
    if (it == s->requests.end()) return -1;
    it->second.num_tokens += 1;
    return 0;
}

// Finish (or cancel) a request: free blocks, release the slot, drop state.
int32_t sched_finish(void* h, int64_t rid) {
    auto* s = static_cast<Scheduler*>(h);
    auto it = s->requests.find(rid);
    if (it == s->requests.end()) return -1;
    Request& req = it->second;
    s->free_request_blocks(req);
    if (req.slot >= 0) s->slots[req.slot] = -1;
    auto w = std::find(s->waiting.begin(), s->waiting.end(), rid);
    if (w != s->waiting.end()) s->waiting.erase(w);
    s->requests.erase(it);
    return 0;
}

// Extend rid's borrowed prefix to `n` blocks total (idempotent for
// smaller n). Returns 0, -1 for an unknown rid, -2 when n exceeds the row.
int32_t sched_lend_prefix(void* h, int64_t rid, int32_t n) {
    auto* s = static_cast<Scheduler*>(h);
    auto it = s->requests.find(rid);
    if (it == s->requests.end()) return -1;
    Request& req = it->second;
    if (n > static_cast<int32_t>(req.blocks.size())) return -2;
    req.num_borrowed = std::max(req.num_borrowed, n);
    return 0;
}

// Return cache-evicted blocks to the free list.
int32_t sched_release_blocks(void* h, const int32_t* blocks, int32_t n) {
    auto* s = static_cast<Scheduler*>(h);
    if (n < 0) return -1;
    for (int32_t i = 0; i < n; ++i) s->free_list.push_back(blocks[i]);
    return 0;
}

int32_t sched_num_borrowed(void* h, int64_t rid) {
    auto* s = static_cast<Scheduler*>(h);
    auto it = s->requests.find(rid);
    return it == s->requests.end() ? -1 : it->second.num_borrowed;
}

int32_t sched_slot(void* h, int64_t rid) {
    auto* s = static_cast<Scheduler*>(h);
    auto it = s->requests.find(rid);
    return it == s->requests.end() ? -1 : it->second.slot;
}

// Write the request's block ids into out (capacity cap); returns the count
// actually owned, or -1 for an unknown rid.
int32_t sched_block_row(void* h, int64_t rid, int32_t* out, int32_t cap) {
    auto* s = static_cast<Scheduler*>(h);
    auto it = s->requests.find(rid);
    if (it == s->requests.end()) return -1;
    const auto& blocks = it->second.blocks;
    int32_t n = static_cast<int32_t>(blocks.size());
    for (int32_t i = 0; i < n && i < cap; ++i) out[i] = blocks[i];
    return n;
}

// Write the slot table's occupied entries as (slot, rid) pairs; returns the
// count. out_slots/out_rids capacity must be max_num_seqs.
int32_t sched_running(void* h, int32_t* out_slots, int64_t* out_rids) {
    auto* s = static_cast<Scheduler*>(h);
    int32_t n = 0;
    for (size_t i = 0; i < s->slots.size(); ++i) {
        if (s->slots[i] < 0) continue;
        out_slots[n] = static_cast<int32_t>(i);
        out_rids[n] = s->slots[i];
        ++n;
    }
    return n;
}

int32_t sched_num_free(void* h) {
    return static_cast<Scheduler*>(h)->num_free();
}

// The free list, bottom to top (the next block handed out last); returns
// its length, writing at most `cap` ids. The port's addition, for
// differential checks against the Python twin's list.
int32_t sched_free_list(void* h, int32_t* out, int32_t cap) {
    auto* s = static_cast<Scheduler*>(h);
    const int32_t n = static_cast<int32_t>(s->free_list.size());
    for (int32_t i = 0; i < n && i < cap; ++i) out[i] = s->free_list[i];
    return n;
}

int32_t sched_num_running(void* h) {
    return static_cast<Scheduler*>(h)->num_running();
}

int32_t sched_num_waiting(void* h) {
    return static_cast<int32_t>(static_cast<Scheduler*>(h)->waiting.size());
}

int32_t sched_has_unfinished(void* h) {
    auto* s = static_cast<Scheduler*>(h);
    return (!s->waiting.empty() || s->num_running() > 0) ? 1 : 0;
}

}  // extern "C"
