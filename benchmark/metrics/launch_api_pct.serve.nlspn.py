"""``launch_api_pct.serve`` in the NLSPN serve cells, which carry
end-to-end metrics of their own."""

from harness import common

read = common.reader("launch_api_pct.serve")
