"""Scale-out: rows across devices (mesh) and worklists across processes
(multihost)."""
