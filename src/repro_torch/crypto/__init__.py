"""Fixed-latency crypto workloads on the crossbar engine (Keccak/SHA-3
in this slice)."""
