"""WKV6 recurrence (RWKV-6 time mix) for Hopper."""
