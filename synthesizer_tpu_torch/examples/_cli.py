"""The command line the examples share: one positional output path and
``--device`` (default ``cuda``; there is no CPU fallback)."""

import argparse


def parse(doc: str, argv, out_default: str, out_help: str):
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("out", nargs="?", default=out_default, help=out_help)
    ap.add_argument("--device", default="cuda",
                    help="where to render (default: the card; 'cpu' on a "
                         "machine without one)")
    return ap.parse_args(argv)
