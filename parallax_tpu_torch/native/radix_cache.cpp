// Native host-side cache structures: page radix tree + free-list allocator.
//
// Capability parity: the reference keeps its runtime hot structures native
// (C++/Metal extension + Rust engines); here the per-request host-side hot
// path — prefix matching over token sequences and page alloc/free — is C++
// behind a C ABI (ctypes), with the pure-Python implementation as fallback
// and behavioral oracle (parallax_tpu/runtime/radix_cache.py).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 radix_cache.cpp -o libradix.so

#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

using Key = std::vector<int32_t>;

struct Node {
    Key key;
    int32_t page_id;
    Node* parent;
    std::map<Key, Node*> children;
    int32_t lock_ref = 0;
    uint64_t last_access = 0;
    // Linear-state snapshot slot at this node's token boundary (hybrid
    // models; -1 = none). Mirrors runtime/radix_cache.py.
    int32_t linear_slot = -1;

    ~Node() {
        for (auto& kv : children) delete kv.second;
    }
};

struct RadixTree {
    Node root;
    int32_t page_size;
    int64_t num_pages = 0;
    uint64_t clock = 0;
    // Snapshot slots orphaned by eviction/reset, drained by the Python
    // side (radix_take_freed_slots) back to the engine's slot pool.
    std::vector<int32_t> freed_slots;

    explicit RadixTree(int32_t ps) : page_size(ps) {
        root.page_id = -1;
        root.parent = nullptr;
    }
};

struct PageAlloc {
    std::vector<int32_t> free_list;
    int32_t num_pages;
    int32_t null_page;
};

Key make_key(const int32_t* tokens, int64_t start, int32_t page) {
    return Key(tokens + start, tokens + start + page);
}

// Shared walk primitives: the piecewise C ABI functions and the batched
// cache-manager ops below must stay behaviorally identical, so both call
// these.

// LRU-evict one unpinned leaf; returns its page id or -1 when none.
int32_t evict_one(RadixTree* t) {
    Node* best = nullptr;
    std::vector<Node*> stack;
    for (auto& kv : t->root.children) stack.push_back(kv.second);
    while (!stack.empty()) {
        Node* cur = stack.back();
        stack.pop_back();
        if (!cur->children.empty()) {
            for (auto& kv : cur->children) stack.push_back(kv.second);
        } else if (cur->lock_ref <= 0) {
            if (!best || cur->last_access < best->last_access) best = cur;
        }
    }
    if (!best) return -1;
    int32_t page = best->page_id;
    if (best->linear_slot >= 0) t->freed_slots.push_back(best->linear_slot);
    best->parent->children.erase(best->key);
    delete best;
    t->num_pages--;
    return page;
}

// Walk to the node covering exactly n_pages full pages of tokens;
// nullptr when the path does not exist.
Node* walk_to(RadixTree* t, const int32_t* tokens, int64_t n_pages) {
    Node* node = &t->root;
    for (int64_t i = 0; i < n_pages; i++) {
        Key key = make_key(tokens, i * t->page_size, t->page_size);
        auto it = node->children.find(key);
        if (it == node->children.end()) return nullptr;
        node = it->second;
    }
    return node;
}

// Walk/extend the tree with full pages of tokens; existing keys with a
// different page report the incoming page as a duplicate.
int64_t insert_walk(RadixTree* t, const int32_t* tokens, int64_t n_full,
                    const int32_t* page_ids, int32_t* out_dups,
                    int64_t max_dups) {
    Node* node = &t->root;
    int64_t n_dups = 0;
    t->clock++;
    for (int64_t i = 0; i < n_full; i++) {
        Key key = make_key(tokens, i * t->page_size, t->page_size);
        auto it = node->children.find(key);
        Node* child;
        if (it == node->children.end()) {
            child = new Node();
            child->key = key;
            child->page_id = page_ids[i];
            child->parent = node;
            node->children.emplace(std::move(key), child);
            t->num_pages++;
        } else {
            child = it->second;
            if (child->page_id != page_ids[i] && n_dups < max_dups) {
                out_dups[n_dups++] = page_ids[i];
            }
        }
        child->last_access = t->clock;
        node = child;
    }
    return n_dups;
}

// Longest full-page prefix match (capped); refreshes access clocks and
// optionally records the node path.
int64_t match_walk(RadixTree* t, const int32_t* tokens, int64_t n_tokens,
                   int64_t max_pages, int32_t* out_pages,
                   std::vector<Node*>* out_path) {
    Node* node = &t->root;
    int64_t matched = 0;
    t->clock++;
    for (int64_t start = 0; matched < max_pages &&
                            start + t->page_size <= n_tokens;
         start += t->page_size) {
        Key key = make_key(tokens, start, t->page_size);
        auto it = node->children.find(key);
        if (it == node->children.end()) break;
        node = it->second;
        node->last_access = t->clock;
        out_pages[matched++] = node->page_id;
        if (out_path) out_path->push_back(node);
    }
    return matched;
}

}  // namespace

extern "C" {

// ---- radix tree -----------------------------------------------------------

void* radix_new(int32_t page_size) { return new RadixTree(page_size); }

void radix_free(void* handle) { delete static_cast<RadixTree*>(handle); }

int64_t radix_num_pages(void* handle) {
    return static_cast<RadixTree*>(handle)->num_pages;
}

// Longest full-page prefix match. Writes matched page ids into out_pages
// (capacity max_out) and returns the match length in pages. Matched nodes
// get their access clocks refreshed.
int64_t radix_match(void* handle, const int32_t* tokens, int64_t n_tokens,
                    int32_t* out_pages, int64_t max_out) {
    auto* t = static_cast<RadixTree*>(handle);
    return match_walk(t, tokens, n_tokens, max_out, out_pages, nullptr);
}

// Adjust lock refs (+1 / -1) along the match path for the given prefix.
void radix_lock(void* handle, const int32_t* tokens, int64_t n_tokens,
                int64_t n_pages, int32_t delta) {
    auto* t = static_cast<RadixTree*>(handle);
    Node* node = &t->root;
    for (int64_t i = 0; i < n_pages; i++) {
        Key key = make_key(tokens, i * t->page_size, t->page_size);
        auto it = node->children.find(key);
        if (it == node->children.end()) return;
        node = it->second;
        node->lock_ref += delta;
    }
}

// Insert full pages; returns the count of *duplicate* page ids written to
// out_dups (pages the caller must free because the key already existed
// with a different page).
int64_t radix_insert(void* handle, const int32_t* tokens, int64_t n_tokens,
                     const int32_t* page_ids, int64_t n_pages,
                     int32_t* out_dups, int64_t max_dups) {
    auto* t = static_cast<RadixTree*>(handle);
    int64_t n_full = n_tokens / t->page_size;
    if (n_pages < n_full) n_full = n_pages;
    return insert_walk(t, tokens, n_full, page_ids, out_dups, max_dups);
}

// Evict up to n unpinned LRU leaves; returns freed page ids in out_pages.
int64_t radix_evict(void* handle, int64_t n, int32_t* out_pages) {
    auto* t = static_cast<RadixTree*>(handle);
    int64_t freed = 0;
    while (freed < n) {
        int32_t page = evict_one(t);
        if (page < 0) break;
        out_pages[freed++] = page;
    }
    return freed;
}

// Drop the whole tree, returning every owned page id.
int64_t radix_reset(void* handle, int32_t* out_pages, int64_t max_out) {
    auto* t = static_cast<RadixTree*>(handle);
    int64_t n = 0;
    std::vector<Node*> stack;
    for (auto& kv : t->root.children) stack.push_back(kv.second);
    while (!stack.empty()) {
        Node* cur = stack.back();
        stack.pop_back();
        if (n < max_out) out_pages[n++] = cur->page_id;
        if (cur->linear_slot >= 0) t->freed_slots.push_back(cur->linear_slot);
        for (auto& kv : cur->children) stack.push_back(kv.second);
    }
    for (auto& kv : t->root.children) delete kv.second;
    t->root.children.clear();
    t->num_pages = 0;
    return n;
}

// Attach a snapshot slot at the node covering exactly n_tokens (a whole
// number of pages); 1 on success, 0 when the node is missing, the length
// is ragged, or a slot is already attached (caller keeps ownership).
int32_t radix_attach_slot(void* handle, const int32_t* tokens,
                          int64_t n_tokens, int32_t slot) {
    auto* t = static_cast<RadixTree*>(handle);
    if (n_tokens <= 0 || n_tokens % t->page_size) return 0;
    Node* node = walk_to(t, tokens, n_tokens / t->page_size);
    if (!node || node->linear_slot >= 0) return 0;
    node->linear_slot = slot;
    return 1;
}

// Reclaim the LRU unpinned snapshot slot (the node keeps its pages);
// returns the slot id or -1.
int32_t radix_detach_lru_slot(void* handle) {
    auto* t = static_cast<RadixTree*>(handle);
    Node* best = nullptr;
    std::vector<Node*> stack;
    for (auto& kv : t->root.children) stack.push_back(kv.second);
    while (!stack.empty()) {
        Node* cur = stack.back();
        stack.pop_back();
        for (auto& kv : cur->children) stack.push_back(kv.second);
        if (cur->linear_slot >= 0 && cur->lock_ref <= 0) {
            if (!best || cur->last_access < best->last_access) best = cur;
        }
    }
    if (!best) return -1;
    int32_t slot = best->linear_slot;
    best->linear_slot = -1;
    return slot;
}

// Drain snapshot slots orphaned by eviction/reset since the last drain.
int64_t radix_take_freed_slots(void* handle, int32_t* out, int64_t max_out) {
    auto* t = static_cast<RadixTree*>(handle);
    int64_t n = 0;
    while (n < max_out && !t->freed_slots.empty()) {
        out[n++] = t->freed_slots.back();
        t->freed_slots.pop_back();
    }
    return n;
}

// ---- batched cache manager ops -------------------------------------------
//
// One ABI crossing per scheduler operation (the round-1 ctypes-per-call
// variant measured 0.4-1.0x Python; the win requires match+lock+evict+
// alloc fused on the native side).

namespace {

int64_t evict_into(RadixTree* t, PageAlloc* a, int64_t need) {
    int64_t freed = 0;
    while (freed < need) {
        int32_t page = evict_one(t);
        if (page < 0) break;
        if (page != a->null_page) a->free_list.push_back(page);
        freed++;
    }
    return freed;
}

}  // namespace

// Admit a prompt in ONE crossing: prefix-match (capped so >=1 token is
// recomputed), lock the matched path, evict-to-fit, allocate fresh pages.
// Writes shared+fresh page ids to out_pages; *out_shared = matched pages.
// Returns total pages, or -1 when memory is insufficient (fully rolled
// back: locks released, nothing allocated).
//
// Hybrid models (linear_state != 0): the match additionally truncates to
// the deepest node carrying a linear-state snapshot (the recurrence
// cannot resume from pages alone); that slot id lands in
// *out_restore_slot (-1 = no hit). max_pages_cap (-1 = none) caps the
// walk for mirror stages that must skip exactly the head's count.
int64_t cache_admit(void* tree_h, void* alloc_h, const int32_t* tokens,
                    int64_t n_tokens, int32_t enable_prefix,
                    int32_t linear_state, int64_t max_pages_cap,
                    int32_t* out_pages, int64_t max_out,
                    int64_t* out_shared, int32_t* out_restore_slot) {
    auto* t = static_cast<RadixTree*>(tree_h);
    auto* a = static_cast<PageAlloc*>(alloc_h);
    int64_t total = (n_tokens + t->page_size - 1) / t->page_size;
    if (total > max_out) return -1;
    *out_restore_slot = -1;

    // Match collecting the node path for lock/unlock. The walk itself is
    // UNCAPPED (bounded by the prompt) and the cap applies afterwards:
    // the Python oracle refreshes every matched node's access clock
    // before capping, and LRU eviction order must agree between the two
    // implementations.
    std::vector<Node*> path;
    int64_t matched = 0;
    if (enable_prefix && n_tokens > 1) {
        int64_t usable = (n_tokens - 1) / t->page_size;
        if (max_pages_cap >= 0 && max_pages_cap < usable) {
            usable = max_pages_cap;
        }
        matched = match_walk(t, tokens, n_tokens, total, out_pages, &path);
        if (matched > usable) {
            matched = usable;
            path.resize(matched);
        }
        if (linear_state) {
            while (matched > 0 && path[matched - 1]->linear_slot < 0) {
                matched--;
            }
            path.resize(matched);
            if (matched > 0) {
                *out_restore_slot = path[matched - 1]->linear_slot;
            }
        }
    }
    for (Node* n : path) n->lock_ref++;

    int64_t fresh = total - matched;
    if ((int64_t)a->free_list.size() < fresh) {
        evict_into(t, a, fresh - (int64_t)a->free_list.size());
    }
    if ((int64_t)a->free_list.size() < fresh) {
        for (Node* n : path) n->lock_ref--;
        return -1;
    }
    for (int64_t i = 0; i < fresh; i++) {
        out_pages[matched + i] = a->free_list.back();
        a->free_list.pop_back();
    }
    *out_shared = matched;
    return total;
}

// Grow a request's page list in ONE crossing: evict-to-fit + allocate.
// Returns n on success, -1 if insufficient even after eviction.
int64_t cache_grow(void* tree_h, void* alloc_h, int64_t n, int32_t* out) {
    auto* t = static_cast<RadixTree*>(tree_h);
    auto* a = static_cast<PageAlloc*>(alloc_h);
    if ((int64_t)a->free_list.size() < n) {
        evict_into(t, a, n - (int64_t)a->free_list.size());
    }
    if ((int64_t)a->free_list.size() < n) return -1;
    for (int64_t i = 0; i < n; i++) {
        out[i] = a->free_list.back();
        a->free_list.pop_back();
    }
    return n;
}

// Release a finished request in ONE crossing: unlock the shared path,
// donate fully-computed pages to the tree, free duplicates + the tail,
// and attach linear-state snapshots (snap_lens[i] tokens -> snap_slots[i])
// to their radix nodes. Unattachable snapshots are reported in
// out_unattached (capacity n_snaps); return value = their count — the
// caller returns those slots to the engine's pool.
// ``computed`` = tokens whose KV is real (the final sampled token's is
// not). ``insert`` = 0 frees everything owned outright (abort path).
int64_t cache_release(void* tree_h, void* alloc_h, const int32_t* tokens,
                      int64_t n_tokens, int64_t computed,
                      const int32_t* pages, int64_t n_pages, int64_t n_shared,
                      int32_t insert,
                      const int64_t* snap_lens, const int32_t* snap_slots,
                      int64_t n_snaps, int32_t* out_unattached) {
    auto* t = static_cast<RadixTree*>(tree_h);
    auto* a = static_cast<PageAlloc*>(alloc_h);
    // Unlock the shared prefix path.
    {
        Node* node = &t->root;
        for (int64_t i = 0; i < n_shared; i++) {
            Key key = make_key(tokens, i * t->page_size, t->page_size);
            auto it = node->children.find(key);
            if (it == node->children.end()) break;
            node = it->second;
            node->lock_ref--;
        }
    }
    int64_t n_unattached = 0;
    if (n_pages <= n_shared || !insert) {
        // Nothing donated: every snapshot slot goes back to the pool,
        // and an abort's owned pages are freed outright.
        for (int64_t i = 0; i < n_snaps; i++) {
            out_unattached[n_unattached++] = snap_slots[i];
        }
        for (int64_t i = n_shared; i < n_pages; i++) {
            if (pages[i] != a->null_page) a->free_list.push_back(pages[i]);
        }
        return n_unattached;
    }
    if (computed > n_tokens) computed = n_tokens;
    int64_t n_full = computed / t->page_size;
    if (n_full > n_pages) n_full = n_pages;
    // Insert the fully-computed prefix; duplicates go straight back to the
    // allocator. (Shared-prefix pages are the tree's own ids, so they can
    // never report as duplicates.)
    {
        std::vector<int32_t> dups(n_full > 0 ? n_full : 1);
        int64_t n_dups = insert_walk(t, tokens, n_full, pages,
                                     dups.data(), (int64_t)dups.size());
        for (int64_t i = 0; i < n_dups; i++) {
            if (dups[i] != a->null_page) a->free_list.push_back(dups[i]);
        }
    }
    // Tail: owned pages past the donated prefix.
    int64_t tail_start = n_full > n_shared ? n_full : n_shared;
    for (int64_t i = tail_start; i < n_pages; i++) {
        if (pages[i] != a->null_page) a->free_list.push_back(pages[i]);
    }
    // Attach snapshots at their exact boundaries within the donated span.
    for (int64_t i = 0; i < n_snaps; i++) {
        int64_t len = snap_lens[i];
        bool ok = len > 0 && len % t->page_size == 0
                  && len <= n_full * t->page_size;
        if (ok) {
            Node* node = walk_to(t, tokens, len / t->page_size);
            ok = node && node->linear_slot < 0;
            if (ok) node->linear_slot = snap_slots[i];
        }
        if (!ok) out_unattached[n_unattached++] = snap_slots[i];
    }
    return n_unattached;
}

// ---- page allocator -------------------------------------------------------

void* alloc_new(int32_t num_pages, int32_t reserve_null) {
    auto* a = new PageAlloc();
    a->num_pages = num_pages;
    a->null_page = reserve_null ? 0 : -1;
    int32_t start = reserve_null ? 1 : 0;
    if (num_pages > start) a->free_list.reserve(num_pages - start);
    for (int32_t p = num_pages - 1; p >= start; p--) a->free_list.push_back(p);
    return a;
}

void alloc_free(void* handle) { delete static_cast<PageAlloc*>(handle); }

int64_t alloc_num_free(void* handle) {
    return static_cast<PageAlloc*>(handle)->free_list.size();
}

// Pop n pages into out; returns n on success, -1 if insufficient.
int64_t alloc_take(void* handle, int64_t n, int32_t* out) {
    auto* a = static_cast<PageAlloc*>(handle);
    if ((int64_t)a->free_list.size() < n) return -1;
    for (int64_t i = 0; i < n; i++) {
        out[i] = a->free_list.back();
        a->free_list.pop_back();
    }
    return n;
}

void alloc_release(void* handle, const int32_t* pages, int64_t n) {
    auto* a = static_cast<PageAlloc*>(handle);
    for (int64_t i = 0; i < n; i++) {
        if (pages[i] != a->null_page) a->free_list.push_back(pages[i]);
    }
}

}  // extern "C"
