"""Serving runtime: paged KV cache, int8 KV tier, layout registry,
events, serve steps."""
