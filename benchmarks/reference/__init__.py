"""Plain NumPy reference of what the window's calls produce.

A frozen copy of VaPoR's semantics as the port's numpy oracle states
them (engine/oracle.py, engine/window.py, engine/cluster.py,
io/cigar.py, io/reads.py, stats/genotype.py, writers/, validators.py),
run on the generator's own records: the genome and each event's reads
drawn again from the seed.  It imports nothing of the program, of jax
or of the JAX package, and reads nothing the program wrote except the
rows it judges.
"""
