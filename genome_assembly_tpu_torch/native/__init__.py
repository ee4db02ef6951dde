"""Native (C++) graph engine, built at first use; no Python fallback."""
