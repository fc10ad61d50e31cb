// Paged-KV block allocator — native host component of the generation
// engine (vLLM's C++ block manager's analogue), the port's copy of
// distllm_tpu/native/block_allocator.cpp, built with g++ at first use.
//
// Free-list allocator with per-block reference counts (refcounts > 1 enable
// prefix sharing of common prompt blocks). Block 0 is reserved as the trash
// block for padded scatter writes (see ops/paged_attention.py) and is never
// handed out.
//
// C ABI for ctypes; no exceptions across the boundary.

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

struct Allocator {
    std::vector<int32_t> free_list;   // LIFO of free block ids
    std::vector<int32_t> refcount;    // per-block refcount (0 = free)
    std::mutex mu;

    explicit Allocator(int32_t num_blocks) : refcount(num_blocks, 0) {
        free_list.reserve(num_blocks > 0 ? num_blocks - 1 : 0);
        // Reserve block 0 (trash block): never enters the free list.
        for (int32_t i = num_blocks - 1; i >= 1; --i) {
            free_list.push_back(i);
        }
        if (num_blocks > 0) refcount[0] = 1;
    }
};

}  // namespace

extern "C" {

void* ba_create(int32_t num_blocks) {
    if (num_blocks < 2) return nullptr;
    return new Allocator(num_blocks);
}

void ba_destroy(void* handle) { delete static_cast<Allocator*>(handle); }

// Returns a block id, or -1 when exhausted.
int32_t ba_alloc(void* handle) {
    auto* a = static_cast<Allocator*>(handle);
    std::lock_guard<std::mutex> lock(a->mu);
    if (a->free_list.empty()) return -1;
    int32_t id = a->free_list.back();
    a->free_list.pop_back();
    a->refcount[id] = 1;
    return id;
}

// Increment refcount (prefix sharing). Returns new refcount or -1 on error.
int32_t ba_incref(void* handle, int32_t id) {
    auto* a = static_cast<Allocator*>(handle);
    std::lock_guard<std::mutex> lock(a->mu);
    if (id <= 0 || id >= (int32_t)a->refcount.size() || a->refcount[id] == 0)
        return -1;
    return ++a->refcount[id];
}

// Decrement refcount; frees the block at zero. Returns new refcount or -1.
int32_t ba_free(void* handle, int32_t id) {
    auto* a = static_cast<Allocator*>(handle);
    std::lock_guard<std::mutex> lock(a->mu);
    if (id <= 0 || id >= (int32_t)a->refcount.size() || a->refcount[id] == 0)
        return -1;
    int32_t rc = --a->refcount[id];
    if (rc == 0) a->free_list.push_back(id);
    return rc;
}

int32_t ba_num_free(void* handle) {
    auto* a = static_cast<Allocator*>(handle);
    std::lock_guard<std::mutex> lock(a->mu);
    return (int32_t)a->free_list.size();
}

}  // extern "C"
