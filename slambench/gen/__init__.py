"""The benchmark's input generator (numpy only)."""
