"""Generate fuzzy_aho_corasick_tpu/utils/_grapheme_tables.py: the UAX #29
extended-grapheme property tables (Grapheme_Cluster_Break,
Extended_Pictographic, Indic_Conjunct_Break) as code-point ranges.

The tables are read from the third-party ``regex`` module's ``\\p{...}``
properties, the same UAX #29 data its ``\\X`` uses; the package itself never
imports ``regex``. Run from the repository root after a Unicode update:

    python tools/gen_grapheme_tables.py
"""

import os

import regex

GCB = ["Other", "CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator",
       "Prepend", "SpacingMark", "L", "V", "T", "LV", "LVT"]
INCB = ["None", "Consonant", "Extend", "Linker"]
EP_BIT = 16
INCB_SHIFT = 5

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "fuzzy_aho_corasick_tpu", "utils", "_grapheme_tables.py",
)


def main() -> None:
    every = "".join(map(chr, range(0x110000)))
    code = [0] * 0x110000

    def mark(prop: str, value: int) -> None:
        for m in regex.finditer(r"\p{%s}+" % prop, every):
            for cp in range(m.start(), m.end()):
                code[cp] |= value

    for i, name in enumerate(GCB[1:], start=1):
        mark(f"Grapheme_Cluster_Break={name}", i)
    mark("Extended_Pictographic", EP_BIT)
    for i, name in enumerate(INCB[1:], start=1):
        mark(f"Indic_Conjunct_Break={name}", i << INCB_SHIFT)

    starts, codes = [0], [code[0]]
    for cp in range(1, 0x110000):
        if code[cp] != codes[-1]:
            starts.append(cp)
            codes.append(code[cp])

    def rows(vals):
        out, line = [], "   "
        for v in vals:
            item = f" {v},"
            if len(line) + len(item) > 79:
                out.append(line)
                line = "   "
            line += item
        out.append(line)
        return "\n".join(out)

    with open(OUT, "w") as f:
        f.write(
            '"""UAX #29 grapheme property ranges. GENERATED by '
            "tools/gen_grapheme_tables.py\n"
            f"from the regex module {regex.__version__}; do not edit.\n\n"
            "Code point ``cp`` has property code ``CODES[i]`` for the last ``i``\n"
            "with ``STARTS[i] <= cp``. A code packs the Grapheme_Cluster_Break\n"
            "value (index into ``GCB``, low 4 bits), Extended_Pictographic\n"
            "(``EP_BIT``) and the Indic_Conjunct_Break value (index into\n"
            '``INCB``, shifted by ``INCB_SHIFT``)."""\n\n'
            f"GCB = {tuple(GCB)!r}\n"
            f"INCB = {tuple(INCB)!r}\n"
            f"EP_BIT = {EP_BIT}\n"
            f"INCB_SHIFT = {INCB_SHIFT}\n\n"
            f"STARTS = (\n{rows(starts)}\n)\n\n"
            f"CODES = (\n{rows(codes)}\n)\n"
        )
    print(f"wrote {OUT}: {len(starts)} ranges")


if __name__ == "__main__":
    main()
