"""Out-of-core engine: block plan, host unit store, synchronous wave."""
