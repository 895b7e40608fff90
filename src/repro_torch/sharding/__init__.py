"""Logical-axis sharding rules and their DTensor placements."""
