"""Device search engine: dispatch layer over the JAX kernels.

Routes ``search_raw`` calls onto the device when the configuration and haystack
are kernel-eligible; the host oracle handles everything else. Eligibility
widens stage by stage (SURVEY §7 build order): exact scan, then the fuzzy
frontier kernel, then prefiltered and sharded paths.
"""

from __future__ import annotations

from typing import List, Optional

from ..structs import FuzzyMatch


def _max_edit_budget(engine) -> Optional[int]:
    """Maximum total-edit budget across global/per-pattern limits, or None
    when a configuration has unbounded per-type semantics the kernels don't
    model (reference limit semantics: src/structs.rs:283-335)."""

    def edits_of(lim) -> int:
        if lim.edits_ is not None:
            return lim.edits_
        return (
            (lim.insertions_ or 0)
            + (lim.deletions_ or 0)
            + (lim.substitutions_ or 0)
            + (lim.swaps_ or 0)
        )

    budget = 0
    for p in engine._patterns:
        lim = p.limits if p.limits is not None else engine.limits
        if lim is not None:
            budget = max(budget, edits_of(lim))
    return budget


class DeviceEngine:
    """Per-engine device dispatcher (lazily constructed by
    :class:`fuzzy_aho_corasick_tpu.automaton.FuzzyAhoCorasick`)."""

    def __init__(self, engine):
        self.engine = engine
        e = engine
        # Exact mode: no edit budget anywhere -> pure trie-walk kernel.
        self._exact_ok = _max_edit_budget(e) == 0 and not e.mappings
        # Beam configs (beam_width / auto_beam) are the reference's *speed*
        # knobs bounding the host BFS frontier (src/search.rs:578-589,
        # 1096-1103). The device DP pipeline has no frontier to bound — its
        # work is structurally bounded — so beamed engines are served by the
        # EXACT DP lanes: bit-identical to the host below the auto-beam
        # budget (where the reference itself is exact, tests.rs:866-917),
        # and the exact superset of the beam-truncated result past it.
        # Beam kernels with per-start oracle rescue are skipped for beamed
        # engines (the rescue would mix beamed-host semantics in); the DP
        # lane declining falls back to the (beamed) host oracle whole.
        self._beamed = e.beam_width is not None or e.auto_beam is not None
        # Fuzzy fast-path mode: global total-edits budget 1..6, no per-pattern
        # limits, no mappings (reference src/builder.rs:446-468 fast-path
        # conditions + device kernel restrictions).
        self._fuzzy_ok = (
            1 <= e.max_edits_fast <= 6
            and not e.has_pattern_limits
            and not e.mappings
            and not e.nodes[0].output  # no empty patterns
        )
        # Mapped mode: FAST budget + multi-char mappings served by the
        # banded DP with static mapping arrivals (reference hot-loop branch
        # src/search.rs:883-923; ops/verify_dp.MappedSpec gates the shapes
        # the DP models — single-byte edges, pb <= 3, |ha - pb| <= 1).
        self._mapped_ok = False
        if (
            1 <= e.max_edits_fast <= 6
            and not e.has_pattern_limits
            and e.mappings
            and not e.nodes[0].output
        ):
            from .verify_dp import mapped_spec_of

            self._mapped_ok = mapped_spec_of(e) is not None
        # Typed mode: per-type caps and/or per-pattern limits served by the
        # type-vector-channel DP (reference general path src/search.rs:87-169;
        # ops/verify_dp.TypedSpec). Requires the packed prefilter model.
        self._typed_ok = False
        if (
            not self._exact_ok
            and not self._fuzzy_ok
            and not self._mapped_ok
            and not e.mappings
            and not e.nodes[0].output
        ):
            from .packed_bitap import packed_fuzzy_of
            from .verify_dp import typed_spec_of, verify_fields_of

            self._typed_ok = (
                typed_spec_of(e) is not None
                and packed_fuzzy_of(e) is not None
                and verify_fields_of(e) is not None
            )

    def supports(self, haystack: str) -> bool:
        """Whether the device path serves this (engine, haystack) pair with
        results identical to the oracle (possibly via internal host
        fallback for haystacks outside a lane's model)."""
        if not (self._exact_ok or self._fuzzy_ok or self._typed_ok
                or self._mapped_ok):
            return False
        # Root-output (empty-pattern) exact configs keep the oracle's NaN
        # semantics; not worth a kernel.
        if self._exact_ok and self.engine.nodes[0].output:
            return False
        return True

    def search_raw(self, haystack: str, threshold: float) -> List[FuzzyMatch]:
        from .packed_bitap import interpret_mode

        interpret_mode()  # raises DeviceUnavailable without a GPU
        if self._exact_ok:
            from .exact import exact_search_device

            return exact_search_device(self.engine, haystack, threshold)
        if self._fuzzy_ok:
            if self._beamed:
                # DP lane only (exact; see _beamed note). Decline -> the
                # whole search falls to the beamed host oracle.
                from .. import oracle
                from ..utils.graphemes import view_of
                from .verify_dp import fuzzy_search_dp

                view = view_of(haystack, self.engine.case_insensitive)
                n = len(view)
                if n == 0:
                    return []
                res = fuzzy_search_dp(self.engine, haystack, threshold, view, n)
                if res is None:
                    from .packed_bitap import packed_fuzzy_of

                    if packed_fuzzy_of(self.engine) is None:
                        from .many import fuzzy_search_many

                        res = fuzzy_search_many(
                            self.engine, haystack, threshold, view, n
                        )
                if res is None:
                    return oracle.search_raw(self.engine, haystack, threshold)
                return res
            from .fuzzy import fuzzy_search_device

            return fuzzy_search_device(self.engine, haystack, threshold)
        if self._mapped_ok:
            from .verify_dp import fuzzy_search_mapped_device

            return fuzzy_search_mapped_device(self.engine, haystack, threshold)
        from .verify_dp import fuzzy_search_typed_device

        return fuzzy_search_typed_device(self.engine, haystack, threshold)
