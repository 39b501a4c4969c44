"""LM serving of the port: the paged KV block pool, the serving programs
and the continuous-batching scheduler."""
