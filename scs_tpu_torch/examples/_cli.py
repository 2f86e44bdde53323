"""The examples' shared command line: an optional count and --device."""

import argparse


def parse(doc: str, count: str = None, default: int = None):
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    if count is not None:
        ap.add_argument(count, type=int, nargs="?", default=default)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args()
