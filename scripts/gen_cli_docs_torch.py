#!/usr/bin/env python
"""Regenerate docs/CLI_torch.md, the reference of the PyTorch port's command
line (``imageprocess-torch``), from its live argparse tree.  Imports no jax.
Run: python scripts/gen_cli_docs_torch.py"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from imageprocess_tpu_torch.cli import build_parser  # noqa: E402
from imageprocess_tpu_torch.core.i18n import set_lang  # noqa: E402


def render() -> str:
    """The full CLI_torch.md content (tests compare this against the
    committed file to catch drift)."""
    set_lang("ko")  # pin: help strings are i18n'd and the committed file
    ap = build_parser()  # is rendered in the default (Korean) catalog
    out = ["# CLI reference: the PyTorch port",
           "",
           "Auto-generated from the argparse tree of"
           " `imageprocess_tpu_torch.cli` by"
           " `scripts/gen_cli_docs_torch.py` — do not edit by hand.",
           "",
           "```",
           ap.format_help().rstrip(),
           "```",
           ""]
    sub = next(a for a in ap._actions
               if a.__class__.__name__ == "_SubParsersAction")
    for name, sp in sub.choices.items():
        out += [f"## `imageprocess-torch {name}`", "", "```",
                sp.format_help().rstrip(), "```", ""]
    return "\n".join(out)


def main():
    path = os.path.join(os.path.dirname(__file__), "..", "docs", "CLI_torch.md")
    content = render()
    with open(path, "w") as f:
        f.write(content)
    print(f"wrote {os.path.normpath(path)}")


if __name__ == "__main__":
    main()
