"""Closed-form work counts (operations and bytes) that the roofline and
utilisation metrics divide by the card's peaks: computed from the cell's
configuration and traffic, never from the program's counters, so a share
reads the same work whatever computes it."""
