"""Serving substrate: prefill/decode step builders, KV-cache shardings."""
