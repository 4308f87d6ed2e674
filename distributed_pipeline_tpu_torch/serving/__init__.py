"""Continuous-batching serving: paged KV cache, engine, scheduler."""
