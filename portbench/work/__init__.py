"""Work counters: FLOPs of a step and each kernel's operations, bytes and
least time on the card."""
