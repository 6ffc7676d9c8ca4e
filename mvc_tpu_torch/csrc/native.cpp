// Native metrics runtime of the port: the C++ twin of the pure-Python paths
// in mvc_tpu_torch/evalcap (the same algorithms as csrc/native.cpp of the
// JAX package, behind a plain C interface loaded with ctypes):
//   * meteor_stats       : the METEOR alignment search over exact / stem /
//                          synonym candidate pairs (evalcap/meteor.py _align)
//   * meteor_align_spans : the span-capable search with stage-4 paraphrase
//                          spans (evalcap/meteor.py _align_spans)
//   * lcs                : longest-common-subsequence length (ROUGE-L)
//   * ptb_tokenize       : PTB word tokenization with the COCO punctuation
//                          strip (evalcap/tokenizer.py), ASCII lines
//
// Words cross the interface as integer ids that the Python side assigns
// (equal ids <=> equal strings); only ptb_tokenize takes text, and it hands
// back token offsets into the lowercased line.  Host code: g++ -O3
// -std=c++17 -shared -fPIC, built at first use by evalcap/_native.py.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <tuple>
#include <utility>
#include <vector>

namespace {

using IdSets = std::vector<std::vector<int64_t>>;

// Per-word synonym-group ids from CSR arrays (offsets [n + 1], ids), each
// set sorted; an empty result when the arrays are null (no synonym stage).
IdSets id_sets(const int64_t* offsets, const int64_t* ids, int n) {
  IdSets out;
  if (offsets == nullptr) return out;
  out.reserve(n);
  for (int i = 0; i < n; ++i) {
    std::vector<int64_t> s(ids + offsets[i], ids + offsets[i + 1]);
    std::sort(s.begin(), s.end());
    out.push_back(std::move(s));
  }
  return out;
}

bool sorted_intersects(const std::vector<int64_t>& a, const std::vector<int64_t>& b) {
  size_t i = 0, j = 0;
  while (i < a.size() && j < b.size()) {
    if (a[i] == b[j]) return true;
    if (a[i] < b[j]) ++i;
    else ++j;
  }
  return false;
}

// The stage weight of the pair (i, j): its EARLIEST matching stage in module
// order (exact, stem, synonym), or a negative value when nothing matches.
struct Words {
  const int32_t *hyp, *hyp_stem, *ref, *ref_stem;
  IdSets hyp_syn, ref_syn;
  double w_exact, w_stem, w_syn;

  double weight(int i, int j) const {
    if (hyp[i] == ref[j]) return w_exact;
    if (hyp_stem[i] == ref_stem[j]) return w_stem;
    if (!hyp_syn.empty() && !hyp_syn[i].empty() && !ref_syn[j].empty() &&
        sorted_intersects(hyp_syn[i], ref_syn[j]))
      return w_syn;
    return -1.0;
  }
};

// ------------------------------------------------------------------ METEOR
// Over all one-to-one matchings drawn from the candidate pairs, the one that
// lexicographically (1) maximizes matches, (2) minimizes chunks, (3)
// minimizes summed |i - j|, (4) maximizes summed stage weight; then the
// score-irrelevant (mask, last_h, last_r), which make the beam cut and the
// final pick a strict total order (as the Python rank).  Beam search over
// hypothesis positions with exact per-(used-ref mask, last match) dominance;
// references are capped at 64 words (the mask width).
struct AlignState {
  uint64_t mask = 0;
  int last_h = -2;
  int last_r = -2;
  int matches = 0;
  int chunks = 0;
  int dist = 0;
  double weighted = 0.0;
  std::vector<double> weights;  // of the matches, in hypothesis order
};

bool align_better(const AlignState& a, const AlignState& b) {
  if (a.matches != b.matches) return a.matches > b.matches;
  if (a.chunks != b.chunks) return a.chunks < b.chunks;
  if (a.dist != b.dist) return a.dist < b.dist;
  if (a.weighted != b.weighted) return a.weighted > b.weighted;
  if (a.mask != b.mask) return a.mask < b.mask;
  if (a.last_h != b.last_h) return a.last_h < b.last_h;
  return a.last_r < b.last_r;
}

struct SpanMatch {
  int hs, hl, rs, rl;
  double w;
};

struct SpanState {
  uint64_t mask = 0;
  int last_h = -2;  // last matched hyp END position
  int last_r = -2;  // last matched ref END position
  int mh = 0, mr = 0, chunks = 0, dist = 0;
  double wsum = 0.0;
  std::vector<SpanMatch> pairs;
};

// (1) max covered words (hyp + ref), (2) min chunks, (3) min summed start
// distance, (4) max summed weight (a span adds w * (hl + rl) / 2), then the
// same total-order keys as align_better.
bool span_better(const SpanState& a, const SpanState& b) {
  int ca = a.mh + a.mr, cb = b.mh + b.mr;
  if (ca != cb) return ca > cb;
  if (a.chunks != b.chunks) return a.chunks < b.chunks;
  if (a.dist != b.dist) return a.dist < b.dist;
  if (a.wsum != b.wsum) return a.wsum > b.wsum;
  if (a.mask != b.mask) return a.mask < b.mask;
  if (a.last_h != b.last_h) return a.last_h < b.last_h;
  return a.last_r < b.last_r;
}

// ------------------------------------------------------------------ PTB
const char* kPunct[] = {"''", "'", "``", "`", "-lrb-", "-rrb-", "-lcb-", "-rcb-", ".",
                        "?",  "!", ",",  ":", "-",     "--",    "...",   ";"};
const char* kContractions[] = {"n't", "'s", "'re", "'ve", "'ll", "'d", "'m"};
const char* kApostrophes[] = {"'s", "'re", "'ve", "'ll", "'d", "'m"};

bool is_punct_token(const std::string& s) {
  for (const char* p : kPunct)
    if (s == p) return true;
  return false;
}

// Python's str.isspace on ASCII (the regex's \s): C's six plus 0x1c..0x1f.
bool is_space(char c) {
  return std::isspace(static_cast<unsigned char>(c)) || (c >= 0x1c && c <= 0x1f);
}
bool is_word_char(char c) { return std::isalpha(static_cast<unsigned char>(c)); }
bool is_digit(char c) { return std::isdigit(static_cast<unsigned char>(c)); }

struct Tokens {
  int32_t *start, *len;
  int capacity, n = 0;
  bool push(size_t s, size_t l) {
    if (n >= capacity) return false;
    start[n] = static_cast<int32_t>(s);
    len[n] = static_cast<int32_t>(l);
    ++n;
    return true;
  }
};

// A word [s, s + l) of the line, its trailing contraction split off.
bool emit_word(const std::string& line, size_t s, size_t l, Tokens& out) {
  for (const char* c : kContractions) {
    size_t cl = strlen(c);
    if (l > cl && line.compare(s + l - cl, cl, c) == 0)
      return out.push(s, l - cl) && out.push(s + l - cl, cl);
  }
  return out.push(s, l);
}

}  // namespace

extern "C" {

// The best alignment: writes its matches' stage weights in hypothesis order
// (up to ``capacity``) and its chunk count, and returns the number of
// matches; -1 when the reference is longer than 64 words, -2 when capacity
// is short.  The caller sums the weights, as the Python path does.  hyp/ref:
// word ids, *_stem: Porter-stem ids; *_syn_off / *_syn: per-word
// synonym-group ids as CSR arrays, both null without the synonym stage.
int meteor_stats(const int32_t* hyp, const int32_t* hyp_stem, int n, const int32_t* ref,
                 const int32_t* ref_stem, int m, double w_exact, double w_stem,
                 const int64_t* hyp_syn_off, const int64_t* hyp_syn,
                 const int64_t* ref_syn_off, const int64_t* ref_syn, double w_syn, int beam,
                 double* out_w, int capacity, int32_t* out_chunks) {
  if (m > 64) return -1;
  Words words{hyp, hyp_stem, ref, ref_stem, id_sets(hyp_syn_off, hyp_syn, n),
              id_sets(ref_syn_off, ref_syn, m), w_exact, w_stem, w_syn};
  if (hyp_syn_off == nullptr || ref_syn_off == nullptr) words.hyp_syn.clear();
  std::vector<std::vector<std::pair<int, double>>> cand(n);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) {
      double w = words.weight(i, j);
      if (w >= 0.0) cand[i].emplace_back(j, w);
    }

  std::map<std::tuple<uint64_t, int, int>, AlignState> states;
  std::vector<AlignState> beam_states{AlignState{}};
  std::vector<AlignState> pool;
  for (int i = 0; i < n; ++i) {
    states.clear();
    auto push = [&states](const AlignState& s) {
      auto k = std::make_tuple(s.mask, s.last_h, s.last_r);
      auto it = states.find(k);
      if (it == states.end() || align_better(s, it->second)) states[k] = s;
    };
    for (const auto& st : beam_states) {
      push(st);  // leave hyp[i] unmatched
      for (const auto& [j, w] : cand[i]) {
        if (st.mask >> j & 1) continue;
        AlignState nx = st;
        nx.mask |= 1ULL << j;
        nx.chunks += (st.last_h == i - 1 && st.last_r == j - 1) ? 0 : 1;
        nx.last_h = i;
        nx.last_r = j;
        nx.matches += 1;
        nx.dist += std::abs(i - j);
        nx.weighted += w;
        nx.weights.push_back(w);
        push(nx);
      }
    }
    pool.clear();
    pool.reserve(states.size());
    for (auto& kv : states) pool.push_back(kv.second);
    if (static_cast<int>(pool.size()) > beam) {
      std::nth_element(pool.begin(), pool.begin() + beam, pool.end(), align_better);
      pool.resize(beam);
    }
    beam_states.swap(pool);
  }
  const AlignState* best = &beam_states[0];
  for (const auto& st : beam_states)
    if (align_better(st, *best)) best = &st;
  if (best->matches > capacity) return -2;
  std::copy(best->weights.begin(), best->weights.end(), out_w);
  *out_chunks = best->chunks;
  return best->matches;
}

// The winning span matching: word stages propose 1x1 spans; the caller adds
// the paraphrase spans per hypothesis START position as CSR arrays
// (span_off [n + 1]; span_hl, span_rs, span_rl, span_w), or null.  Writes
// up to ``capacity`` matches (hs, hl, rs, rl, w) and returns their count;
// -1 when the reference is longer than 64 words, -2 when capacity is short.
int meteor_align_spans(const int32_t* hyp, const int32_t* hyp_stem, int n, const int32_t* ref,
                       const int32_t* ref_stem, int m, double w_exact, double w_stem,
                       const int64_t* hyp_syn_off, const int64_t* hyp_syn,
                       const int64_t* ref_syn_off, const int64_t* ref_syn, double w_syn,
                       const int32_t* span_off, const int32_t* span_hl, const int32_t* span_rs,
                       const int32_t* span_rl, const double* span_w, int beam, int32_t* out_hs,
                       int32_t* out_hl, int32_t* out_rs, int32_t* out_rl, double* out_w,
                       int capacity) {
  if (m > 64) return -1;
  Words words{hyp, hyp_stem, ref, ref_stem, id_sets(hyp_syn_off, hyp_syn, n),
              id_sets(ref_syn_off, ref_syn, m), w_exact, w_stem, w_syn};
  if (hyp_syn_off == nullptr || ref_syn_off == nullptr) words.hyp_syn.clear();
  std::vector<std::vector<SpanMatch>> cand(n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < m; ++j) {
      double w = words.weight(i, j);
      if (w >= 0.0) cand[i].push_back({i, 1, j, 1, w});
    }
    if (span_off != nullptr)
      for (int q = span_off[i]; q < span_off[i + 1]; ++q)
        cand[i].push_back({i, span_hl[q], span_rs[q], span_rl[q], span_w[q]});
  }

  // beam search over hyp positions, bucketed by position (spans advance by
  // hl); per-(mask, last_h, last_r) dominance within a bucket
  using Key = std::tuple<uint64_t, int, int>;
  std::vector<std::map<Key, SpanState>> buckets(n + 1);
  buckets[0][{0, -2, -2}] = SpanState{};
  auto push = [&buckets](int pos, SpanState&& s) {
    Key k{s.mask, s.last_h, s.last_r};
    auto& bucket = buckets[pos];
    auto it = bucket.find(k);
    if (it == bucket.end() || span_better(s, it->second)) bucket[k] = std::move(s);
  };
  std::vector<SpanState> pool;
  for (int i = 0; i < n; ++i) {
    pool.clear();
    pool.reserve(buckets[i].size());
    for (auto& kv : buckets[i]) pool.push_back(std::move(kv.second));
    buckets[i].clear();
    if (static_cast<int>(pool.size()) > beam) {
      std::nth_element(pool.begin(), pool.begin() + beam, pool.end(), span_better);
      pool.resize(beam);
    }
    for (auto& st : pool) {
      for (const auto& c : cand[i]) {
        uint64_t span = ((c.rl >= 64 ? ~0ULL : ((1ULL << c.rl) - 1)) << c.rs);
        if (st.mask & span) continue;
        SpanState nx = st;
        nx.mask |= span;
        nx.chunks += (st.last_h == i - 1 && st.last_r == c.rs - 1) ? 0 : 1;
        nx.last_h = i + c.hl - 1;
        nx.last_r = c.rs + c.rl - 1;
        nx.mh += c.hl;
        nx.mr += c.rl;
        nx.dist += std::abs(i - c.rs);
        nx.wsum += c.w * (c.hl + c.rl) / 2.0;
        nx.pairs.push_back(c);
        push(i + c.hl, std::move(nx));
      }
      push(i + 1, std::move(st));  // leave hyp[i] unmatched (moved LAST)
    }
  }
  const SpanState* best = nullptr;
  for (const auto& kv : buckets[n])
    if (best == nullptr || span_better(kv.second, *best)) best = &kv.second;
  if (best == nullptr) return 0;
  if (static_cast<int>(best->pairs.size()) > capacity) return -2;
  for (size_t q = 0; q < best->pairs.size(); ++q) {
    const auto& p = best->pairs[q];
    out_hs[q] = p.hs;
    out_hl[q] = p.hl;
    out_rs[q] = p.rs;
    out_rl[q] = p.rl;
    out_w[q] = p.w;
  }
  return static_cast<int>(best->pairs.size());
}

// LCS length of two id sequences (rolling-row DP over the shorter one).
int lcs(const int32_t* a, int na, const int32_t* b, int nb) {
  if (na < nb) {
    std::swap(a, b);
    std::swap(na, nb);
  }
  if (nb == 0) return 0;
  std::vector<int> prev(nb + 1, 0), cur(nb + 1, 0);
  for (int i = 0; i < na; ++i) {
    for (int j = 1; j <= nb; ++j)
      cur[j] = (a[i] == b[j - 1]) ? prev[j - 1] + 1 : std::max(prev[j], cur[j - 1]);
    std::swap(prev, cur);
  }
  return prev[nb];
}

// PTB tokens of an ASCII line, lowercased, punctuation stripped: writes each
// token's (start, length) in the lowercased line and returns the count, or
// -1 when more than ``capacity`` tokens.
int ptb_tokenize(const char* text, int length, int32_t* out_start, int32_t* out_len,
                 int capacity) {
  std::string line(text, static_cast<size_t>(length));
  for (auto& ch : line) ch = static_cast<char>(std::tolower(static_cast<unsigned char>(ch)));
  Tokens out{out_start, out_len, capacity};
  size_t i = 0;
  const size_t n = line.size();
  while (i < n) {
    char c = line[i];
    if (is_space(c)) {
      ++i;
      continue;
    }
    if (c == '.' && i + 2 < n && line[i + 1] == '.' && line[i + 2] == '.') {
      i += 3;  // "..." is stripped punctuation
      continue;
    }
    if (c == '-' && i + 1 < n && line[i + 1] == '-') {
      i += 2;  // "--"
      continue;
    }
    if (c == 'n' && line.compare(i, 3, "n't") == 0) {
      // a standalone "n't" outranks the word pattern (regex alternation order)
      if (!out.push(i, 3)) return -1;
      i += 3;
      continue;
    }
    if (is_word_char(c)) {
      size_t j = i;
      bool used_apostrophe = false;  // a word holds ONE internal apostrophe
      while (j < n) {
        if (is_word_char(line[j])) {
          ++j;
        } else if (line[j] == '\'' && !used_apostrophe && j > i && j + 1 < n &&
                   is_word_char(line[j + 1])) {
          used_apostrophe = true;
          ++j;
        } else {
          break;
        }
      }
      if (!emit_word(line, i, j - i, out)) return -1;
      i = j;
      continue;
    }
    if (is_digit(c)) {
      size_t j = i;
      while (j < n && (is_digit(line[j]) || ((line[j] == '.' || line[j] == ',') && j + 1 < n &&
                                             is_digit(line[j + 1]))))
        ++j;
      if (!out.push(i, j - i)) return -1;
      i = j;
      continue;
    }
    if (c == '\'') {
      // standalone 's 're 've 'll 'd 'm, as in the regex's alternation
      bool matched = false;
      for (const char* a : kApostrophes) {
        size_t al = strlen(a);
        if (line.compare(i, al, a) == 0) {
          if (!out.push(i, al)) return -1;
          i += al;
          matched = true;
          break;
        }
      }
      if (matched) continue;
    }
    // one punctuation character; brackets are PTB's -lrb- etc., all stripped
    bool bracket = c == '(' || c == ')' || c == '{' || c == '}';
    if (!bracket && !is_punct_token(std::string(1, c)) && !out.push(i, 1)) return -1;
    ++i;
  }
  return out.n;
}

}  // extern "C"
