"""One loop module for each kind of traffic (traffic/<mix>.json names it)."""
