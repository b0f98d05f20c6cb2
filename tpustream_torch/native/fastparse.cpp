// Fast columnar line parser for the host ingest path.
//
// The reference parses records inside per-record JVM MapFunctions
// (split + Double.parseDouble, chapter1/.../Main.java:18-26; ISO-8601 +
// UTC+8 epoch seconds, chapter3/.../BandwidthMonitorWithEventTime.java:32-34).
// At the >=10M events/sec/chip target (BASELINE.json) host-side parsing
// is the first bottleneck (SURVEY.md §7 "hard parts"), so the symbolic
// parse plans compile down to this C++ kernel: one pass over a newline-
// separated byte buffer, splitting on a single-byte separator and
// materializing int64 / float64 / interned-string-id / iso8601-epoch
// columns directly into caller-provided numpy buffers. tsp_parse_mt
// chunks the buffer at newline boundaries across threads.
//
// Build: the package's __init__.py runs the Makefile beside this file
// into build/torch_native/ at the root of the checkout (no external
// dependencies; ctypes-friendly C ABI).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// An intern table: ids in first-seen order, found through an open-
// addressed (linear probing) array of slots. A slot holds its string's
// id, a 32-bit tag of its hash and, up to kInline bytes, the string
// itself, so a hit on a short key reads one cache line, which the parse
// prefetches for a group of lines before it resolves them (at a million
// keys each lookup is otherwise a cache miss, and a node-based map takes
// several in turn).
struct Table {
    static constexpr uint32_t kInline = 20;
    struct Slot {
        int32_t id;  // -1: empty
        uint32_t tag;
        uint32_t len;
        char key[kInline];
    };
    std::vector<std::string> to_str;
    std::vector<Slot> slots;  // a power of two long, at most 3/4 full
    size_t mask = 0;

    static uint64_t hash(const char* s, size_t n) {
        uint64_t h = 0x9E3779B97F4A7C15ull ^ (static_cast<uint64_t>(n) * 0xFF51AFD7ED558CCDull);
        size_t i = 0;
        for (; i + 8 <= n; i += 8) {
            uint64_t w;
            std::memcpy(&w, s + i, 8);
            h = (h ^ w) * 0xC4CEB9FE1A85EC53ull;
            h ^= h >> 29;
        }
        if (i < n) {
            uint64_t w = 0;
            std::memcpy(&w, s + i, n - i);
            h = (h ^ w) * 0xC4CEB9FE1A85EC53ull;
        }
        h ^= h >> 33;
        h *= 0xFF51AFD7ED558CCDull;
        h ^= h >> 33;
        return h;
    }

    void prefetch(uint64_t h) const {
        if (!slots.empty()) __builtin_prefetch(&slots[h & mask]);
    }

    // the id of s (hash h), or -1 when s was never interned
    int32_t find(const char* s, size_t n, uint64_t h) const {
        if (slots.empty()) return -1;
        const uint32_t tag = static_cast<uint32_t>(h >> 32);
        for (size_t i = h & mask;; i = (i + 1) & mask) {
            const Slot& sl = slots[i];
            if (sl.id < 0) return -1;
            if (sl.tag != tag || sl.len != n) continue;
            const char* t = n <= kInline ? sl.key : to_str[static_cast<size_t>(sl.id)].data();
            if (std::memcmp(t, s, n) == 0) return sl.id;
        }
    }

    void place(const std::string& t, uint64_t h, int32_t id) {
        size_t i = h & mask;
        while (slots[i].id >= 0) i = (i + 1) & mask;
        Slot& sl = slots[i];
        sl.id = id;
        sl.tag = static_cast<uint32_t>(h >> 32);
        sl.len = static_cast<uint32_t>(t.size());
        if (t.size() <= kInline) std::memcpy(sl.key, t.data(), t.size());
    }

    void grow() {
        size_t cap = slots.empty() ? 1024 : slots.size() * 2;
        slots.assign(cap, Slot{-1, 0, 0, {}});
        mask = cap - 1;
        for (size_t id = 0; id < to_str.size(); id++) {
            const std::string& t = to_str[id];
            place(t, hash(t.data(), t.size()), static_cast<int32_t>(id));
        }
    }

    int32_t intern(const char* s, size_t n, uint64_t h) {
        int32_t id = find(s, n, h);
        if (id >= 0) return id;
        id = static_cast<int32_t>(to_str.size());
        to_str.emplace_back(s, n);
        if (to_str.size() * 4 > slots.size() * 3) grow();  // places every id
        else place(to_str.back(), h, id);
        return id;
    }

    int32_t intern(const char* s, size_t n) { return intern(s, n, hash(s, n)); }
};

// Howard Hinnant's days-from-civil algorithm (public-domain formula).
inline int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
    y -= m <= 2;
    const int64_t era = (y >= 0 ? y : y - 399) / 400;
    const int64_t yoe = y - era * 400;
    const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + doe - 719468;
}

inline bool parse2(const char* p, int64_t* out) {
    if (p[0] < '0' || p[0] > '9' || p[1] < '0' || p[1] > '9') return false;
    *out = (p[0] - '0') * 10 + (p[1] - '0');
    return true;
}

// "YYYY-MM-DDTHH:MM:SS" (optionally more, ignored) -> epoch seconds,
// interpreting the naive datetime at UTC+tz_hours (Java
// LocalDateTime.toEpochSecond(ZoneOffset.ofHours(tz))).
inline bool parse_iso(const char* s, size_t n, int tz_hours, int64_t* out) {
    if (n < 19) return false;
    int64_t y = 0;
    for (int i = 0; i < 4; i++) {
        if (s[i] < '0' || s[i] > '9') return false;
        y = y * 10 + (s[i] - '0');
    }
    int64_t mo, d, h, mi, se;
    if (s[4] != '-' || s[7] != '-' || (s[10] != 'T' && s[10] != ' ') ||
        s[13] != ':' || s[16] != ':')
        return false;
    if (!parse2(s + 5, &mo) || !parse2(s + 8, &d) || !parse2(s + 11, &h) ||
        !parse2(s + 14, &mi) || !parse2(s + 17, &se))
        return false;
    *out = days_from_civil(y, mo, d) * 86400 + h * 3600 + mi * 60 + se -
           static_cast<int64_t>(tz_hours) * 3600;
    return true;
}

inline int64_t parse_i64_tok(const char* s, size_t n) {
    int64_t v = 0;
    bool neg = false;
    size_t i = 0;
    if (n && (s[0] == '-' || s[0] == '+')) {
        neg = s[0] == '-';
        i = 1;
    }
    for (; i < n; i++) {
        if (s[i] < '0' || s[i] > '9') break;
        v = v * 10 + (s[i] - '0');
    }
    return neg ? -v : v;
}

inline double parse_f64_tok(const char* s, size_t n) {
    char buf[64];
    size_t m = n < 63 ? n : 63;
    std::memcpy(buf, s, m);
    buf[m] = '\0';
    return std::strtod(buf, nullptr);
}

constexpr int KIND_STR = 0;
constexpr int KIND_F64 = 1;
constexpr int KIND_I64 = 2;
constexpr int KIND_ISO = 3;

// The one tokenize/convert loop both entry points share. Interning is
// parameterized: serial passes locals == nullptr and interns straight
// into the shared tables; MT workers read the shared tables (read-only
// during the parallel phase) and assign negative placeholder ids from
// their thread-local tables for unseen strings. Lines go in groups of
// kGroup: the first pass converts every other field and hashes each
// string, prefetching its slot; the second resolves the strings in line
// order, so ids are assigned in the order of a plain line-by-line pass.
constexpr int64_t kGroup = 32;

int64_t parse_range(const char* p, const char* end, char sep, int32_t n_out,
                    const int32_t* field_idx, const int32_t* kinds,
                    const int32_t* tz_hours, Table** tables, Table* locals,
                    void** out_cols, int64_t row, int64_t row_limit,
                    int64_t* bad_out) {
    int32_t max_field = 0;
    for (int32_t i = 0; i < n_out; i++)
        if (field_idx[i] > max_field) max_field = field_idx[i];
    std::vector<const char*> tok_start(static_cast<size_t>(max_field) + 1);
    std::vector<size_t> tok_len(static_cast<size_t>(max_field) + 1);
    std::vector<int32_t> str_out;  // the KIND_STR outputs, in order
    for (int32_t i = 0; i < n_out; i++)
        if (kinds[i] == KIND_STR) str_out.push_back(i);
    const size_t ns = str_out.size();
    struct Pending {
        const char* s;
        size_t n;
        uint64_t h;
    };
    std::vector<Pending> pending(static_cast<size_t>(kGroup) * ns);

    int64_t bad = 0;
    while (p < end && row < row_limit) {
        const int64_t first = row;
        // pass 1: up to kGroup non-empty lines
        while (row - first < kGroup && p < end && row < row_limit) {
            const char* nl = static_cast<const char*>(
                std::memchr(p, '\n', static_cast<size_t>(end - p)));
            const char* line_end = nl ? nl : end;
            int32_t nt = 0;
            const char* q = p;
            while (q <= line_end && nt <= max_field) {
                const char* t = q;
                while (q < line_end && *q != sep) q++;
                tok_start[static_cast<size_t>(nt)] = t;
                tok_len[static_cast<size_t>(nt)] = static_cast<size_t>(q - t);
                nt++;
                if (q < line_end) q++;  // skip separator
                else break;
            }
            if (line_end > p) {  // skip empty lines entirely
                bool row_bad = false;
                size_t k = 0;
                for (int32_t i = 0; i < n_out; i++) {
                    int32_t fi = field_idx[i];
                    const char* ts = fi < nt ? tok_start[static_cast<size_t>(fi)] : "";
                    size_t tn = fi < nt ? tok_len[static_cast<size_t>(fi)] : 0;
                    if (fi >= nt) row_bad = true;
                    switch (kinds[i]) {
                        case KIND_STR: {
                            Pending& pd = pending[static_cast<size_t>(row - first) * ns + k++];
                            pd.s = ts;
                            pd.n = tn;
                            pd.h = Table::hash(ts, tn);
                            tables[i]->prefetch(pd.h);
                            break;
                        }
                        case KIND_F64:
                            static_cast<double*>(out_cols[i])[row] =
                                tn ? parse_f64_tok(ts, tn) : 0.0;
                            break;
                        case KIND_I64:
                            static_cast<int64_t*>(out_cols[i])[row] =
                                tn ? parse_i64_tok(ts, tn) : 0;
                            break;
                        case KIND_ISO: {
                            int64_t v = 0;
                            if (!parse_iso(ts, tn, tz_hours[i], &v)) row_bad = true;
                            static_cast<int64_t*>(out_cols[i])[row] = v;
                            break;
                        }
                    }
                }
                if (row_bad) bad++;
                row++;
            }
            p = nl ? nl + 1 : end;
        }
        // pass 2: the group's strings, line by line
        for (int64_t r = first; r < row; r++) {
            for (size_t k = 0; k < ns; k++) {
                const int32_t i = str_out[k];
                const Pending& pd = pending[static_cast<size_t>(r - first) * ns + k];
                int32_t id;
                if (locals == nullptr) {
                    id = tables[i]->intern(pd.s, pd.n, pd.h);
                } else {
                    id = tables[i]->find(pd.s, pd.n, pd.h);
                    if (id < 0) id = -locals[i].intern(pd.s, pd.n, pd.h) - 1;
                }
                static_cast<int32_t*>(out_cols[i])[r] = id;
            }
        }
    }
    if (bad_out) *bad_out += bad;
    return row;
}

}  // namespace

extern "C" {

Table* tsp_table_new() { return new Table(); }

void tsp_table_free(Table* t) { delete t; }

int64_t tsp_table_size(Table* t) {
    return static_cast<int64_t>(t->to_str.size());
}

int64_t tsp_table_get(Table* t, int64_t idx, char* out, int64_t cap) {
    if (idx < 0 || idx >= static_cast<int64_t>(t->to_str.size())) return -1;
    const std::string& s = t->to_str[static_cast<size_t>(idx)];
    int64_t n = static_cast<int64_t>(s.size());
    if (n > cap) n = cap;
    std::memcpy(out, s.data(), static_cast<size_t>(n));
    return static_cast<int64_t>(s.size());
}

// Parse `len` bytes of newline-separated records.
//   n_out columns, described by parallel arrays:
//     field_idx[i]  separator-delimited token index
//     kinds[i]      KIND_* above
//     tz_hours[i]   timezone offset for KIND_ISO
//     tables[i]     intern table for KIND_STR (else null)
//     out_cols[i]   pre-allocated buffer: int32 (STR), double (F64),
//                   int64 (I64/ISO), length >= max_rows
// Returns the number of rows parsed (<= max_rows); *bad_lines counts rows
// with missing/malformed tokens (their cells fill with 0 / id of "").
int64_t tsp_parse(const char* buf, int64_t len, char sep, int32_t n_out,
                  const int32_t* field_idx, const int32_t* kinds,
                  const int32_t* tz_hours, Table** tables, void** out_cols,
                  int64_t max_rows, int64_t* bad_lines) {
    int64_t bad = 0;
    int64_t rows = parse_range(buf, buf + len, sep, n_out, field_idx, kinds,
                               tz_hours, tables, nullptr, out_cols, 0,
                               max_rows, &bad);
    if (bad_lines) *bad_lines = bad;
    return rows;
}

// Multi-threaded tsp_parse. Output is IDENTICAL to the serial kernel,
// including first-seen intern-id order: the thread-local placeholder
// tables are merged in chunk order (chunk order == stream order) after
// the parallel phase, and placeholder cells rewritten. Falls back to
// the serial kernel for small buffers or when the row count would
// exceed max_rows.
int64_t tsp_parse_mt(const char* buf, int64_t len, char sep, int32_t n_out,
                     const int32_t* field_idx, const int32_t* kinds,
                     const int32_t* tz_hours, Table** tables, void** out_cols,
                     int64_t max_rows, int64_t* bad_lines, int32_t n_threads) {
    if (n_threads > 64) n_threads = 64;  // sanity clamp (thread spawn cost)
    if (n_threads <= 1 || len < (1 << 20))
        return tsp_parse(buf, len, sep, n_out, field_idx, kinds, tz_hours,
                         tables, out_cols, max_rows, bad_lines);

    // chunk boundaries on newlines
    int32_t T = n_threads;
    std::vector<int64_t> start(static_cast<size_t>(T) + 1, len);
    start[0] = 0;
    for (int32_t t = 1; t < T; t++) {
        int64_t pos = len * t / T;
        if (pos <= start[static_cast<size_t>(t) - 1]) pos = start[static_cast<size_t>(t) - 1];
        const char* nl = static_cast<const char*>(
            std::memchr(buf + pos, '\n', static_cast<size_t>(len - pos)));
        start[static_cast<size_t>(t)] = nl ? (nl - buf) + 1 : len;
    }
    start[static_cast<size_t>(T)] = len;

    // phase 1: count non-empty lines per chunk
    std::vector<int64_t> counts(static_cast<size_t>(T), 0);
    {
        std::vector<std::thread> ths;
        for (int32_t t = 0; t < T; t++) {
            ths.emplace_back([&, t] {
                const char* p = buf + start[static_cast<size_t>(t)];
                const char* end = buf + start[static_cast<size_t>(t) + 1];
                int64_t c = 0;
                while (p < end) {
                    const char* nl = static_cast<const char*>(
                        std::memchr(p, '\n', static_cast<size_t>(end - p)));
                    const char* le = nl ? nl : end;
                    if (le > p) c++;
                    if (!nl) break;
                    p = nl + 1;
                }
                counts[static_cast<size_t>(t)] = c;
            });
        }
        for (auto& th : ths) th.join();
    }
    std::vector<int64_t> offset(static_cast<size_t>(T) + 1, 0);
    for (int32_t t = 0; t < T; t++)
        offset[static_cast<size_t>(t) + 1] = offset[static_cast<size_t>(t)] + counts[static_cast<size_t>(t)];
    if (offset[static_cast<size_t>(T)] > max_rows)
        return tsp_parse(buf, len, sep, n_out, field_idx, kinds, tz_hours,
                         tables, out_cols, max_rows, bad_lines);

    // phase 2: parallel parse via the shared kernel (local intern tables)
    std::vector<std::vector<Table>> local(static_cast<size_t>(T));
    for (auto& v : local) v.resize(static_cast<size_t>(n_out));
    std::vector<int64_t> bads(static_cast<size_t>(T), 0);
    {
        std::vector<std::thread> ths;
        for (int32_t t = 0; t < T; t++) {
            ths.emplace_back([&, t] {
                parse_range(buf + start[static_cast<size_t>(t)],
                            buf + start[static_cast<size_t>(t) + 1], sep,
                            n_out, field_idx, kinds, tz_hours, tables,
                            local[static_cast<size_t>(t)].data(), out_cols,
                            offset[static_cast<size_t>(t)],
                            offset[static_cast<size_t>(t) + 1],
                            &bads[static_cast<size_t>(t)]);
            });
        }
        for (auto& th : ths) th.join();
    }

    // phase 3: merge local tables in chunk order, rewrite placeholders
    for (int32_t i = 0; i < n_out; i++) {
        if (kinds[i] != KIND_STR) continue;
        int32_t* col = static_cast<int32_t*>(out_cols[i]);
        for (int32_t t = 0; t < T; t++) {
            Table& loc = local[static_cast<size_t>(t)][static_cast<size_t>(i)];
            if (loc.to_str.empty()) continue;
            std::vector<int32_t> remap(loc.to_str.size());
            for (size_t j = 0; j < loc.to_str.size(); j++) {
                const std::string& s = loc.to_str[j];
                remap[j] = tables[i]->intern(s.data(), s.size());
            }
            for (int64_t r = offset[static_cast<size_t>(t)];
                 r < offset[static_cast<size_t>(t) + 1]; r++) {
                if (col[r] < 0) col[r] = remap[static_cast<size_t>(-col[r] - 1)];
            }
        }
    }

    int64_t bad_total = 0;
    for (int32_t t = 0; t < T; t++) bad_total += bads[static_cast<size_t>(t)];
    if (bad_lines) *bad_lines = bad_total;
    return offset[static_cast<size_t>(T)];
}

}  // extern "C"
