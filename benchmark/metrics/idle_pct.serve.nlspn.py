"""``idle_pct.serve`` in the NLSPN serve cells, whose runs spread less than
the flagship's, so that their end-to-end metrics carry bounds of their
own."""

from harness import common

read = common.reader("idle_pct.serve")
