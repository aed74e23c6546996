"""fuzzy_aho_corasick_tpu — fuzzy multi-pattern matching on the GPU.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
``fuzzy-aho-corasick`` Rust crate (reference mounted at /root/reference;
public surface mirrors src/lib.rs:96-105): Unicode-aware Aho-Corasick with
fuzzy matching — substitutions, insertions, deletions, transpositions over
grapheme clusters — plus similarity scoring, per-pattern limits and weights,
multi-character mappings, a bit-parallel prefilter, segmentation/replace
helpers, and streaming over arbitrarily large inputs.

The automaton compiles to dense device tables; searches run as anchored
per-start-position scans vectorized across GPU threads, shard data-parallel
over a device mesh with halo overlap, and fall back to an exact host oracle
for configurations the kernels don't cover. Similarity for a length-``N``
pattern is ``(N - penalties) / N * weight`` (f32), identical to the
reference.

Example::

    from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits, SearchOptions

    engine = (FuzzyAhoCorasickBuilder.new()
              .fuzzy(FuzzyLimits.new().edits(1))
              .case_insensitive(True)
              .build(["hello", "world"]))
    opts = SearchOptions.new().with_threshold(0.8).sorted().non_overlapping()
    for m in engine.search("helllo wolrd", opts):
        print(m.pattern.pattern, m.start, m.end, m.similarity)
"""

from .utils.hostmem import (
    enable_compile_cache as _enable_compile_cache,
    tune_host_allocator as _tune_host_allocator,
)

_tune_host_allocator()
_enable_compile_cache()

from .automaton import FuzzyAhoCorasick
from .builder import FuzzyAhoCorasickBuilder
from .errors import HaystackTooLarge, SearchError
from .matches import FuzzyMatches
from .options import DEFAULT_THRESHOLD, Order, Overlap, SearchOptions
from .prefilter import Prefiltered
from .replacer import FuzzyReplacer
from .stream import StreamMatch, StreamMatches
from .structs import (
    FuzzyLimits,
    FuzzyMatch,
    FuzzyPenalties,
    NumEdits,
    Pattern,
    PatternIndex,
    Segment,
    Similarity,
    UnmatchedSegment,
)

__version__ = "0.1.0"

__all__ = [
    "FuzzyAhoCorasick",
    "FuzzyAhoCorasickBuilder",
    "FuzzyLimits",
    "FuzzyMatch",
    "FuzzyMatches",
    "FuzzyPenalties",
    "FuzzyReplacer",
    "HaystackTooLarge",
    "NumEdits",
    "Order",
    "Overlap",
    "Pattern",
    "PatternIndex",
    "Prefiltered",
    "SearchError",
    "SearchOptions",
    "Segment",
    "Similarity",
    "StreamMatch",
    "StreamMatches",
    "UnmatchedSegment",
    "DEFAULT_THRESHOLD",
]
