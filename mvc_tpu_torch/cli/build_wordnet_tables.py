"""Build the METEOR synonym table and the SPICE POS lexicon from a WordNet
database directory, the port of ``scripts/build_wordnet_tables.py`` (same
flags, byte-identical outputs).  WNDB format: the ``dict/`` directory of the
standard WordNet 3.x distribution, with ``index.*``, ``data.*`` and ``*.exc``
files.

    python -m mvc_tpu_torch.cli.build_wordnet_tables --wndb /path/to/WordNet-3.0/dict \\
        --synonyms-out meteor_synonyms.txt --lexicon-out spice_lexicon.txt

The metrics read what it writes, and cannot ship the data themselves:

- METEOR's stage 3 matches words that share a synonym group
  (``evalcap/meteor.py``: one whitespace-separated group per line;
  ``cli.train --meteor_synonyms meteor_synonyms.txt``);
- SPICE needs a POS lexicon for its scene graphs (``evalcap/spice.py``:
  ``word pos[,pos...] [lemma]`` per line; ``MVC_SPICE_LEXICON`` or
  ``Spice(lexicon=...)``).

WNDB line formats (wndb(5WN)):
- ``data.<pos>``:  ``offset lex_filenum ss_type w_cnt word lex_id [word
  lex_id]... p_cnt ...``; ``w_cnt`` is 2-digit hex; words use ``_`` for
  spaces and may carry ``(...)`` syntactic markers.
- ``index.<pos>``: ``lemma pos synset_cnt p_cnt [ptr_symbol...]
  sense_cnt tagsense_cnt synset_offset...``.
- ``<pos>.exc``:   ``inflected_form base_form...`` (irregular morphology).

Host only; no device is involved.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

POS_FILES = {"noun": "n", "verb": "v", "adj": "a", "adv": "r"}
SS_TYPE_TO_POS = {"n": "noun", "v": "verb", "a": "adj", "s": "adj", "r": "adv"}


def _clean_word(w: str) -> str | None:
    """WNDB word field -> single lowercase token, or None to skip."""
    w = w.lower()
    if "(" in w:                       # strip adjective syntactic markers
        w = w[: w.index("(")]
    if not w or "_" in w or "'" in w or "." in w or "-" in w:
        return None                    # multiword / abbreviation / hyphenated
    return w if w.isalpha() else None


def parse_data_file(path: str):
    """Yield lists of single-token synset members."""
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith("  ") or not line.strip():
                continue               # license header lines
            fields = line.split()
            if len(fields) < 5:
                continue
            try:
                w_cnt = int(fields[3], 16)
            except ValueError:
                continue
            words = []
            for i in range(w_cnt):
                w = _clean_word(fields[4 + 2 * i])
                if w:
                    words.append(w)
            if len(words) >= 2:
                yield words


def parse_index_file(path: str, pos: str):
    """Yield (lemma, pos, tagsense_cnt)."""
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith("  ") or not line.strip():
                continue
            fields = line.split()
            if len(fields) < 6:
                continue
            lemma = _clean_word(fields[0])
            if not lemma:
                continue
            p_cnt = int(fields[3])
            try:
                tagsense = int(fields[5 + p_cnt])
            except (IndexError, ValueError):
                tagsense = 0
            yield lemma, pos, tagsense


def parse_exc_file(path: str, pos: str):
    """Yield (inflected, pos, base) irregular-morphology pairs."""
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            fields = line.split()
            if len(fields) < 2:
                continue
            infl = _clean_word(fields[0])
            base = _clean_word(fields[1])
            if infl and base and infl != base:
                yield infl, pos, base


def build(wndb: str, synonyms_out: str | None, lexicon_out: str | None) -> dict:
    stats = {"groups": 0, "lexicon_words": 0, "exc_entries": 0}

    if synonyms_out:
        seen = set()
        n = 0
        with open(synonyms_out, "w", encoding="utf-8") as out:
            for pos in POS_FILES:
                p = os.path.join(wndb, f"data.{pos}")
                if not os.path.isfile(p):
                    continue
                for words in parse_data_file(p):
                    key = tuple(sorted(set(words)))
                    if len(key) < 2 or key in seen:
                        continue
                    seen.add(key)
                    out.write(" ".join(key) + "\n")
                    n += 1
        stats["groups"] = n

    if lexicon_out:
        # lemma -> {pos: max tagsense_cnt}; exc -> explicit inflected entries
        poses: dict[str, dict[str, int]] = defaultdict(dict)
        lemma_of: dict[str, str] = {}
        for pos in POS_FILES:
            p = os.path.join(wndb, f"index.{pos}")
            if not os.path.isfile(p):
                continue
            for lemma, ps, tag in parse_index_file(p, pos):
                poses[lemma][ps] = max(poses[lemma].get(ps, 0), tag)
        n_exc = 0
        exc_rows = []
        for pos in POS_FILES:
            p = os.path.join(wndb, f"{pos}.exc")
            if not os.path.isfile(p):
                continue
            for infl, ps, base in parse_exc_file(p, pos):
                if infl not in poses:          # don't shadow real lemmas
                    exc_rows.append((infl, ps, base))
                    n_exc += 1
        with open(lexicon_out, "w", encoding="utf-8") as out:
            # the JAX script's header, word for word: both write the same bytes
            out.write("# word pos[,pos...] [lemma] — generated by "
                      "scripts/build_wordnet_tables.py\n")
            for lemma in sorted(poses):
                ordered = sorted(poses[lemma], key=lambda ps: -poses[lemma][ps])
                out.write(f"{lemma} {','.join(ordered)}\n")
            for infl, ps, base in sorted(exc_rows):
                out.write(f"{infl} {ps} {base}\n")
        stats["lexicon_words"] = len(poses)
        stats["exc_entries"] = n_exc

    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wndb", required=True,
                    help="WordNet dict/ directory (index.*, data.*, *.exc)")
    ap.add_argument("--synonyms-out", default=None,
                    help="METEOR synonym table output path")
    ap.add_argument("--lexicon-out", default=None,
                    help="SPICE POS lexicon output path")
    args = ap.parse_args(argv)
    if not args.synonyms_out and not args.lexicon_out:
        ap.error("nothing to do: pass --synonyms-out and/or --lexicon-out")
    stats = build(args.wndb, args.synonyms_out, args.lexicon_out)
    print(f"synonym groups: {stats['groups']}, lexicon words: "
          f"{stats['lexicon_words']} (+{stats['exc_entries']} irregular forms)")
    return stats


if __name__ == "__main__":
    main()
