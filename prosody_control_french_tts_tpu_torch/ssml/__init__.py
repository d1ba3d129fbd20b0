"""SSML construction: syntagmes → <prosody>/<break> tags (host-side)."""
