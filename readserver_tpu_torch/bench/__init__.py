"""Programs of the port that run as processes of their own
(``multihost_bench``: one rank of a process group)."""
