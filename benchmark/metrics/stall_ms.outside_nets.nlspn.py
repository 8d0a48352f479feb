"""``stall_ms.outside_nets`` in the NLSPN serve cells, which carry
end-to-end metrics of their own."""

from harness import common

read = common.reader("stall_ms.outside_nets")
