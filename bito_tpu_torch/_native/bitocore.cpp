// bitocore: native host-side kernels for bito_tpu.
//
// TPU-native rebuild of the reference's flex/bison Newick parser
// (reference: src/parser.yy, src/scanner.ll, src/driver.cpp:1-227) and the
// UnrootedPCSPPreorder counter machinery (src/sbn_maps.cpp:120-192,
// src/node.cpp:306-352).  These are the host-side throughput hot spots when
// ingesting MCMC tree files with thousands of trees; the compute path stays
// in XLA.
//
// C ABI (consumed via ctypes from bito_tpu/_native/__init__.py):
//   - newick/nexus parsing into flat parent/branch-length arrays
//   - per-topology virtual-rooting rootsplit + PCSP enumeration with
//     clade bitsets packed into uint64 blocks (any taxon count).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 bitocore.cpp -o libbitocore.so

#include <algorithm>
#include <cstdint>
#include <stdexcept>
#include <cctype>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ParsedTree {
  std::vector<int32_t> parents;  // node id -> parent id (root: -1)
  std::vector<double> lengths;   // node id -> branch length above
};

struct ParseResult {
  std::vector<std::string> taxa;
  std::vector<ParsedTree> trees;
  std::string error;
};

struct Parser {
  const std::string& s;
  size_t i = 0;
  std::unordered_map<std::string, int>& taxon_ids;
  bool allow_new;

  explicit Parser(const std::string& text,
                  std::unordered_map<std::string, int>& ids, bool allow)
      : s(text), taxon_ids(ids), allow_new(allow) {}

  void SkipWsComments() {
    while (i < s.size()) {
      char c = s[i];
      if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
        i++;
      } else if (c == '[') {
        int depth = 1;
        i++;
        while (i < s.size() && depth) {
          if (s[i] == '[') depth++;
          else if (s[i] == ']') depth--;
          i++;
        }
      } else {
        break;
      }
    }
  }

  std::string ParseLabel() {
    SkipWsComments();
    std::string out;
    if (i < s.size() && s[i] == '\'') {
      i++;
      while (i < s.size()) {
        if (s[i] == '\'') {
          if (i + 1 < s.size() && s[i + 1] == '\'') {
            out += '\'';
            i += 2;
          } else {
            i++;
            break;
          }
        } else {
          out += s[i++];
        }
      }
      return out;
    }
    while (i < s.size() && strchr("():,;[ \t\r\n", s[i]) == nullptr) {
      out += s[i++];
    }
    return out;
  }

  // Node in construction: children ids into a scratch vector.
  struct PNode {
    std::vector<int> children;
    std::string label;
    double length = 0.0;
    bool is_leaf = false;
  };
  std::vector<PNode> nodes;

  int ParseNode() {
    SkipWsComments();
    int id = static_cast<int>(nodes.size());
    nodes.emplace_back();
    if (i < s.size() && s[i] == '(') {
      i++;
      while (true) {
        int child = ParseNode();
        nodes[id].children.push_back(child);
        SkipWsComments();
        if (i < s.size() && s[i] == ',') {
          i++;
          continue;
        }
        break;
      }
      SkipWsComments();
      if (i >= s.size() || s[i] != ')') throw std::runtime_error("expected )");
      i++;
    }
    std::string label = ParseLabel();
    nodes[id].label = label;
    nodes[id].is_leaf = nodes[id].children.empty();
    SkipWsComments();
    if (i < s.size() && s[i] == ':') {
      i++;
      SkipWsComments();
      size_t start = i;
      while (i < s.size() &&
             (isdigit(s[i]) || strchr(".+-eE", s[i]) != nullptr)) {
        i++;
      }
      nodes[id].length = std::stod(s.substr(start, i - start));
    }
    return id;
  }

  ParsedTree Finish(int root) {
    // Count leaves, register taxa, assign ids: leaves = taxon id,
    // internals postorder starting at taxon_count (global across trees).
    // First pass: leaves in-order.
    std::vector<int> order;  // postorder of scratch ids
    std::vector<std::pair<int, bool>> stack{{root, false}};
    while (!stack.empty()) {
      auto [n, expanded] = stack.back();
      stack.pop_back();
      if (expanded) {
        order.push_back(n);
      } else {
        stack.emplace_back(n, true);
        auto& ch = nodes[n].children;
        for (auto it = ch.rbegin(); it != ch.rend(); ++it) {
          stack.emplace_back(*it, false);
        }
      }
    }
    for (int n : order) {
      if (nodes[n].is_leaf) {
        auto it = taxon_ids.find(nodes[n].label);
        if (it == taxon_ids.end()) {
          if (!allow_new) {
            throw std::runtime_error("unknown taxon " + nodes[n].label);
          }
          taxon_ids.emplace(nodes[n].label,
                            static_cast<int>(taxon_ids.size()));
        }
      }
    }
    int taxon_count = static_cast<int>(taxon_ids.size());
    std::vector<int> new_id(nodes.size(), -1);
    int next_internal = taxon_count;
    for (int n : order) {
      new_id[n] = nodes[n].is_leaf ? taxon_ids.at(nodes[n].label)
                                   : next_internal++;
    }
    ParsedTree out;
    out.parents.assign(next_internal, -1);
    out.lengths.assign(next_internal, 0.0);
    for (size_t n = 0; n < nodes.size(); n++) {
      if (new_id[n] < 0) continue;
      out.lengths[new_id[n]] = nodes[n].length;
      for (int c : nodes[n].children) {
        out.parents[new_id[c]] = new_id[static_cast<int>(n)];
      }
    }
    out.parents[new_id[root]] = -1;
    return out;
  }
};

ParseResult* ParseText(const std::string& text, bool is_nexus) {
  auto* result = new ParseResult();
  try {
    std::unordered_map<std::string, int> taxon_ids;
    std::vector<std::string> tree_strings;
    std::vector<std::string> key_order;  // nexus translate keys
    if (is_nexus) {
      // Minimal nexus: translate table + tree lines.
      std::unordered_map<std::string, std::string> translate;
      size_t pos = 0;
      bool in_translate = false;
      while (pos < text.size()) {
        size_t eol = text.find('\n', pos);
        if (eol == std::string::npos) eol = text.size();
        std::string line = text.substr(pos, eol - pos);
        pos = eol + 1;
        // strip
        size_t a = line.find_first_not_of(" \t\r");
        if (a == std::string::npos) continue;
        size_t b = line.find_last_not_of(" \t\r");
        line = line.substr(a, b - a + 1);
        std::string low = line;
        for (auto& c : low) c = static_cast<char>(tolower(c));
        if (low.rfind("translate", 0) == 0) {
          in_translate = true;
          line = line.substr(9);
          if (line.empty()) continue;
        }
        if (in_translate && !line.empty() && line[0] == '(') {
          in_translate = false;
        }
        if (in_translate) {
          bool ended = !line.empty() && line.back() == ';';
          while (!line.empty() &&
                 (line.back() == ';' || line.back() == ',')) {
            line.pop_back();
          }
          size_t start = 0;
          while (start < line.size()) {
            size_t comma = line.find(',', start);
            std::string entry = line.substr(
                start, comma == std::string::npos ? std::string::npos
                                                  : comma - start);
            size_t sp = entry.find_first_of(" \t");
            if (sp != std::string::npos) {
              std::string key = entry.substr(0, sp);
              std::string val = entry.substr(sp + 1);
              size_t va = val.find_first_not_of(" \t'");
              size_t vb = val.find_last_not_of(" \t'");
              if (va != std::string::npos) {
                val = val.substr(va, vb - va + 1);
                translate[key] = val;
                key_order.push_back(key);
              }
            }
            if (comma == std::string::npos) break;
            start = comma + 1;
          }
          if (ended) in_translate = false;
          continue;
        }
        if (low.rfind("tree ", 0) == 0) {
          // Find '=' outside bracket comments (BEAST [&lnP=...] metadata).
          int depth = 0;
          size_t eq = std::string::npos;
          for (size_t ci = 0; ci < line.size(); ci++) {
            if (line[ci] == '[') depth++;
            else if (line[ci] == ']') depth--;
            else if (line[ci] == '=' && depth == 0) { eq = ci; break; }
          }
          if (eq != std::string::npos) {
            std::string t = line.substr(eq + 1);
            size_t ta = t.find_first_not_of(" \t");
            tree_strings.push_back(t.substr(ta));
          }
        } else if (!line.empty() && line[0] == '(') {
          tree_strings.push_back(line);
        }
      }
      if (translate.empty()) throw std::runtime_error("no translate table");
      for (const auto& k : key_order) {
        taxon_ids.emplace(k, static_cast<int>(taxon_ids.size()));
        result->taxa.push_back(translate.at(k));
      }
      for (const auto& ts : tree_strings) {
        Parser p(ts, taxon_ids, false);
        int root = p.ParseNode();
        result->trees.push_back(p.Finish(root));
      }
    } else {
      size_t pos = 0;
      while (pos < text.size()) {
        size_t eol = text.find('\n', pos);
        if (eol == std::string::npos) eol = text.size();
        std::string line = text.substr(pos, eol - pos);
        pos = eol + 1;
        size_t a = line.find_first_not_of(" \t\r");
        if (a == std::string::npos) continue;
        if (line[a] == '#') continue;
        tree_strings.push_back(line.substr(a));
      }
      // First pass registers taxa in order of appearance.
      for (const auto& ts : tree_strings) {
        Parser p(ts, taxon_ids, true);
        int root = p.ParseNode();
        result->trees.push_back(p.Finish(root));
      }
      result->taxa.resize(taxon_ids.size());
      for (const auto& [name, id] : taxon_ids) result->taxa[id] = name;
    }
  } catch (const std::exception& e) {
    result->error = e.what();
  }
  return result;
}

// ---------------------------------------------------------------------------
// Virtual-rooting rootsplit/PCSP counters (reference sbn_maps.cpp:120-192)
// with clades as uint64-block bitsets.
// ---------------------------------------------------------------------------
using Blocks = std::vector<uint64_t>;

struct BlocksHash {
  size_t operator()(const Blocks& b) const {
    size_t h = 1469598103934665603ull;
    for (uint64_t x : b) {
      h ^= x;
      h *= 1099511628211ull;
    }
    return h;
  }
};

struct CounterResult {
  // Each entry: concatenated blocks; rootsplit = 2 clades, pcsp = 3 clades.
  std::vector<Blocks> rootsplits;
  std::vector<int64_t> rootsplit_counts;
  std::vector<Blocks> pcsps;
  std::vector<int64_t> pcsp_counts;
  std::string error;
};

// String-lexicographic ("position 0 first") comparison of clades; the
// reference Bitset::Compare (src/bitset.cpp).  Bit i of block i/64 is
// position i.
int CompareClades(const Blocks& a, const Blocks& b) {
  for (size_t blk = 0; blk < a.size(); blk++) {
    uint64_t x = a[blk], y = b[blk];
    if (x == y) continue;
    uint64_t diff = x ^ y;
    uint64_t low = diff & ~(diff - 1);  // lowest differing bit
    return (x & low) ? 1 : -1;  // position set in x -> x is string-larger
  }
  return 0;
}

void SortedSubsplit(const Blocks& a, const Blocks& b, Blocks* out) {
  // Larger clade (string order) first, as the reference sorts.
  const Blocks& first = CompareClades(a, b) >= 0 ? a : b;
  const Blocks& second = CompareClades(a, b) >= 0 ? b : a;
  out->clear();
  out->insert(out->end(), first.begin(), first.end());
  out->insert(out->end(), second.begin(), second.end());
}

struct TopoCtx {
  int n_taxa;
  int n_blocks;
  std::vector<std::vector<int>> children;
  std::vector<int> parent;
  std::vector<Blocks> below;  // clade below each node
  Blocks full;
};

void ComputeBelow(TopoCtx& ctx) {
  int N = static_cast<int>(ctx.parent.size());
  ctx.below.assign(N, Blocks(ctx.n_blocks, 0));
  for (int v = 0; v < ctx.n_taxa; v++) {
    ctx.below[v][v / 64] |= 1ull << (v % 64);
  }
  for (int v = ctx.n_taxa; v < N; v++) {
    for (int c : ctx.children[v]) {
      for (int b = 0; b < ctx.n_blocks; b++) {
        ctx.below[v][b] |= ctx.below[c][b];
      }
    }
  }
}

inline Blocks Complement(const TopoCtx& ctx, const Blocks& x) {
  Blocks out(ctx.n_blocks);
  for (int b = 0; b < ctx.n_blocks; b++) out[b] = ctx.full[b] & ~x[b];
  return out;
}

inline bool Contains(const Blocks& big, const Blocks& small) {
  for (size_t b = 0; b < big.size(); b++) {
    if ((small[b] & ~big[b]) != 0) return false;
  }
  return true;
}

// Enumerate the rooted subsplit pairs for rooting at `edge`
// (the clade arithmetic of bito_tpu/sbn/maps.py virtual_rooted_subsplits).
// Emits one PCSP key (sister|focal|small-child-clade blocks) per internal
// node of the virtually rooted tree into `keys`.
void RootingPCSPKeys(const TopoCtx& ctx, int edge, std::vector<Blocks>* keys) {
  int N = static_cast<int>(ctx.parent.size());
  int root = N - 1;
  const Blocks& Bu = ctx.below[edge];
  std::vector<Blocks> subsplit(N);
  std::vector<int> new_parent(N, -2);
  for (int v = ctx.n_taxa; v < N; v++) {
    int old_parent = (v == root) ? -1 : ctx.parent[v];
    std::vector<int> new_children;
    int np;
    if (v == edge) {
      np = -1;
      new_children = ctx.children[v];
    } else if (Contains(ctx.below[v], Bu)) {
      int toward = -1;
      for (int c : ctx.children[v]) {
        if (Contains(ctx.below[c], Bu)) {
          toward = c;
          break;
        }
      }
      np = (toward == edge) ? -1 : toward;
      for (int c : ctx.children[v]) {
        if (c != toward) new_children.push_back(c);
      }
      if (old_parent != -1) new_children.push_back(old_parent);
    } else {
      np = old_parent;
      new_children = ctx.children[v];
    }
    if (new_children.size() != 2) {
      throw std::runtime_error(
          "unrooted counters need trifurcating-root bifurcating trees "
          "(deroot rooted trees first)");
    }
    Blocks c0 = (new_children[0] == old_parent)
                    ? Complement(ctx, ctx.below[v])
                    : ctx.below[new_children[0]];
    Blocks c1 = (new_children[1] == old_parent)
                    ? Complement(ctx, ctx.below[v])
                    : ctx.below[new_children[1]];
    SortedSubsplit(c0, c1, &subsplit[v]);
    new_parent[v] = np;
  }
  // Emit PCSPs: parent arranged sister|focal, child = smaller clade.
  Blocks comp = Complement(ctx, Bu);
  Blocks rootsplit;
  SortedSubsplit(Bu, comp, &rootsplit);
  int nb = ctx.n_blocks;
  for (int v = ctx.n_taxa; v < N; v++) {
    Blocks parent_ss;
    if (new_parent[v] == -1) {
      parent_ss = rootsplit;
    } else {
      parent_ss = subsplit[new_parent[v]];
    }
    // Arrange parent as sister|focal where focal == union of child.
    Blocks cu(nb, 0);
    const Blocks& css = subsplit[v];
    for (int b = 0; b < nb; b++) cu[b] = css[b] | css[nb + b];
    Blocks sister(nb), focal(nb);
    bool focal_is_first = true;
    for (int b = 0; b < nb; b++) {
      if (parent_ss[b] != cu[b]) {
        focal_is_first = false;
        break;
      }
    }
    for (int b = 0; b < nb; b++) {
      if (focal_is_first) {
        focal[b] = parent_ss[b];
        sister[b] = parent_ss[nb + b];
      } else {
        sister[b] = parent_ss[b];
        focal[b] = parent_ss[nb + b];
      }
    }
    // Child clade stored: the string-lex smaller of the child's clades.
    Blocks ca(css.begin(), css.begin() + nb);
    Blocks cb(css.begin() + nb, css.end());
    const Blocks& small = CompareClades(ca, cb) < 0 ? ca : cb;
    Blocks pcsp;
    pcsp.reserve(3 * nb);
    pcsp.insert(pcsp.end(), sister.begin(), sister.end());
    pcsp.insert(pcsp.end(), focal.begin(), focal.end());
    pcsp.insert(pcsp.end(), small.begin(), small.end());
    keys->push_back(std::move(pcsp));
  }
}

void VirtualRootedPCSPs(
    const TopoCtx& ctx, int edge,
    std::unordered_map<Blocks, int64_t, BlocksHash>* pcsp_set) {
  std::vector<Blocks> keys;
  RootingPCSPKeys(ctx, edge, &keys);
  for (auto& k : keys) (*pcsp_set)[std::move(k)] = 1;
}

// The UCA->rootsplit PCSP key for rooting at `edge`
// (bito_tpu/sbn/maps.py pcsp_from_uca_to_rootsplit): sister = empty,
// focal = full taxon set, child = string-lex smaller rootsplit clade.
Blocks RootsplitPCSPKey(const TopoCtx& ctx, int edge) {
  int nb = ctx.n_blocks;
  Blocks comp = Complement(ctx, ctx.below[edge]);
  const Blocks& small =
      CompareClades(ctx.below[edge], comp) < 0 ? ctx.below[edge] : comp;
  Blocks key(3 * nb, 0);
  for (int b = 0; b < nb; b++) key[nb + b] = ctx.full[b];
  for (int b = 0; b < nb; b++) key[2 * nb + b] = small[b];
  return key;
}

struct IndexerHandle {
  std::unordered_map<Blocks, int64_t, BlocksHash> map;
  int nb = 0;
  std::string error;
};

TopoCtx MakeCtx(const int32_t* parents, int N, int n_taxa, int n_blocks) {
  TopoCtx ctx;
  ctx.n_taxa = n_taxa;
  ctx.n_blocks = n_blocks;
  ctx.parent.assign(parents, parents + N);
  ctx.children.assign(N, {});
  for (int v = 0; v < N - 1; v++) ctx.children[ctx.parent[v]].push_back(v);
  ctx.full.assign(n_blocks, 0);
  for (int v = 0; v < n_taxa; v++) ctx.full[v / 64] |= 1ull << (v % 64);
  ComputeBelow(ctx);
  return ctx;
}

}  // namespace

extern "C" {

void* bc_parse(const char* text, int is_nexus) {
  return ParseText(std::string(text), is_nexus != 0);
}

const char* bc_error(void* h) {
  auto* r = static_cast<ParseResult*>(h);
  return r->error.empty() ? nullptr : r->error.c_str();
}

int bc_num_trees(void* h) {
  return static_cast<int>(static_cast<ParseResult*>(h)->trees.size());
}

int bc_num_taxa(void* h) {
  return static_cast<int>(static_cast<ParseResult*>(h)->taxa.size());
}

const char* bc_taxon_name(void* h, int i) {
  return static_cast<ParseResult*>(h)->taxa[i].c_str();
}

int bc_tree_size(void* h, int t) {
  return static_cast<int>(
      static_cast<ParseResult*>(h)->trees[t].parents.size());
}

void bc_tree_data(void* h, int t, int32_t* parents, double* lengths) {
  auto& tree = static_cast<ParseResult*>(h)->trees[t];
  memcpy(parents, tree.parents.data(), tree.parents.size() * sizeof(int32_t));
  memcpy(lengths, tree.lengths.data(), tree.lengths.size() * sizeof(double));
}

void bc_free(void* h) { delete static_cast<ParseResult*>(h); }

// Unrooted counters over a batch of topologies.
// parents: concatenated parent arrays; sizes: nodes per tree;
// counts: multiplicity per topology.  Returns a CounterResult handle.
void* bc_unrooted_counters(const int32_t* parents, const int32_t* sizes,
                           const int64_t* topo_counts, int num_trees,
                           int n_taxa) {
  auto* out = new CounterResult();
  try {
  int n_blocks = (n_taxa + 63) / 64;
  std::unordered_map<Blocks, int64_t, BlocksHash> rs_counter, pcsp_counter;
  size_t offset = 0;
  for (int t = 0; t < num_trees; t++) {
    int N = sizes[t];
    TopoCtx ctx;
    ctx.n_taxa = n_taxa;
    ctx.n_blocks = n_blocks;
    ctx.parent.assign(parents + offset, parents + offset + N);
    offset += N;
    ctx.children.assign(N, {});
    for (int v = 0; v < N - 1; v++) ctx.children[ctx.parent[v]].push_back(v);
    ctx.full.assign(n_blocks, 0);
    for (int v = 0; v < n_taxa; v++) ctx.full[v / 64] |= 1ull << (v % 64);
    ComputeBelow(ctx);
    std::unordered_map<Blocks, int64_t, BlocksHash> tree_pcsps;
    for (int e = 0; e < N - 1; e++) {
      Blocks comp = Complement(ctx, ctx.below[e]);
      Blocks rs;
      SortedSubsplit(ctx.below[e], comp, &rs);
      rs_counter[rs] += topo_counts[t];
      VirtualRootedPCSPs(ctx, e, &tree_pcsps);
    }
    for (const auto& [pcsp, one] : tree_pcsps) {
      pcsp_counter[pcsp] += topo_counts[t];
    }
  }
  for (auto& [k, v] : rs_counter) {
    out->rootsplits.push_back(k);
    out->rootsplit_counts.push_back(v);
  }
  for (auto& [k, v] : pcsp_counter) {
    out->pcsps.push_back(k);
    out->pcsp_counts.push_back(v);
  }
  } catch (const std::exception& e) {
    out->error = e.what();
  }
  return out;
}

const char* bc_counter_error(void* h) {
  auto* r = static_cast<CounterResult*>(h);
  return r->error.empty() ? nullptr : r->error.c_str();
}

int bc_counter_rootsplit_count(void* h) {
  return static_cast<int>(static_cast<CounterResult*>(h)->rootsplits.size());
}

int bc_counter_pcsp_count(void* h) {
  return static_cast<int>(static_cast<CounterResult*>(h)->pcsps.size());
}

void bc_counter_data(void* h, uint64_t* rs_blocks, int64_t* rs_counts,
                     uint64_t* pcsp_blocks, int64_t* pcsp_counts) {
  auto* r = static_cast<CounterResult*>(h);
  size_t off = 0;
  for (size_t i = 0; i < r->rootsplits.size(); i++) {
    memcpy(rs_blocks + off, r->rootsplits[i].data(),
           r->rootsplits[i].size() * sizeof(uint64_t));
    off += r->rootsplits[i].size();
    rs_counts[i] = r->rootsplit_counts[i];
  }
  off = 0;
  for (size_t i = 0; i < r->pcsps.size(); i++) {
    memcpy(pcsp_blocks + off, r->pcsps[i].data(),
           r->pcsps[i].size() * sizeof(uint64_t));
    off += r->pcsps[i].size();
    pcsp_counts[i] = r->pcsp_counts[i];
  }
}

void bc_counter_free(void* h) { delete static_cast<CounterResult*>(h); }

// ---------------------------------------------------------------------------
// Indexer representations (reference UnrootedSBNMaps::IndexerRepresentationOf,
// src/sbn_maps.cpp:200-262): per virtual rooting, [UCA->rootsplit index,
// sorted PCSP indices...].  The indexer is uploaded once per support as
// concatenated 3*nb-block PCSP keys.
// ---------------------------------------------------------------------------

void* bc_pcsp_indexer(const uint64_t* blocks, const int64_t* indices,
                      int count, int nb) {
  auto* h = new IndexerHandle();
  h->nb = nb;
  h->map.reserve(static_cast<size_t>(count) * 2);
  for (int i = 0; i < count; i++) {
    Blocks key(blocks + static_cast<size_t>(i) * 3 * nb,
               blocks + static_cast<size_t>(i + 1) * 3 * nb);
    h->map[std::move(key)] = indices[i];
  }
  return h;
}

void bc_pcsp_indexer_free(void* h) { delete static_cast<IndexerHandle*>(h); }

const char* bc_indexer_error(void* h) {
  auto* r = static_cast<IndexerHandle*>(h);
  return r->error.empty() ? nullptr : r->error.c_str();
}

// out shape: [num_trees * (N-1) rows, 1 + (N - n_taxa)] int64, where N is
// the (common) node count.  Returns 0 on success, -1 on error (message via
// bc_indexer_error on the indexer handle).
int bc_unrooted_representations(void* idx_handle, const int32_t* parents,
                                const int32_t* sizes, int num_trees,
                                int n_taxa, int64_t default_index,
                                int64_t* out) {
  auto* idx = static_cast<IndexerHandle*>(idx_handle);
  idx->error.clear();
  try {
    int n_blocks = (n_taxa + 63) / 64;
    size_t offset = 0;
    size_t pos = 0;
    for (int t = 0; t < num_trees; t++) {
      int N = sizes[t];
      int row_len = 1 + (N - n_taxa);
      TopoCtx ctx = MakeCtx(parents + offset, N, n_taxa, n_blocks);
      offset += N;
      std::vector<Blocks> keys;
      for (int e = 0; e < N - 1; e++) {
        Blocks root_key = RootsplitPCSPKey(ctx, e);
        auto it = idx->map.find(root_key);
        out[pos++] = (it == idx->map.end()) ? default_index : it->second;
        keys.clear();
        RootingPCSPKeys(ctx, e, &keys);
        if (static_cast<int>(keys.size()) != row_len - 1) {
          throw std::runtime_error("internal: rooting emitted " +
                                   std::to_string(keys.size()) + " PCSPs, " +
                                   "expected " + std::to_string(row_len - 1));
        }
        int64_t* row = out + pos;
        for (size_t k = 0; k < keys.size(); k++) {
          auto kit = idx->map.find(keys[k]);
          row[k] = (kit == idx->map.end()) ? default_index : kit->second;
        }
        std::sort(row, row + keys.size());
        pos += row_len - 1;
      }
    }
  } catch (const std::exception& e) {
    idx->error = e.what();
    return -1;
  }
  return 0;
}

}  // extern "C"
