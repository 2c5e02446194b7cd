"""CLI: one JSON row a formulation of the Mosaic repros, then the
verdict in the repro scripts' words (see the package docstring)."""
from __future__ import annotations

import argparse
import json
import sys

from . import REPROS, run, tile_32768
from .. import card_line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(REPROS),
                    help="comma-separated of " + ",".join(REPROS) +
                    ",tile (tile: the T = 32768 tiled render, card only)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--json", default="",
                    help="append one JSON line per formulation here")
    args = ap.parse_args(argv)
    only = [k.strip().lower() for k in args.only.split(",") if k.strip()]
    bad = sorted(set(only) - set(REPROS) - {"tile"})
    if bad:
        ap.error(f"unknown --only {bad}: choose from "
                 f"{','.join(REPROS)},tile")
    card_line(args.device)           # raises without a card
    rows = run(args.device, [k for k in only if k != "tile"], args.launches)
    verdicts = [line for key in only if key != "tile"
                for line in REPROS[key].verdict(
                    [r for r in rows if r["kernel"] == f"K{key[1:]}"])]
    if "tile" in only:
        tile = tile_32768.run(args.device)
        rows.append(dict(kernel="tile", name="T=32768 tile",
                         device=card_line(args.device), **tile))
        verdicts += tile_32768.verdict(tile)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    for line in verdicts:
        print(line)
    ok = all(r.get("ok", r.get("agrees") and r.get("as_expected")
                   and r.get("forms_equal") is not False) for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
