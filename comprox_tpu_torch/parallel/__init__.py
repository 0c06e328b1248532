"""Block-level parallelism: G blocks through one launch a pass on one card."""
