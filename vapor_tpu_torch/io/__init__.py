from .fasta import FastaFile, write_fasta, reverse_complement, complement
from .bam import BamReader, BamRecord, write_bam
from .cigar import clip_read_to_window
from .reads import resolve_bam_inputs, extract_spanning_reads, subsample_reads

__all__ = [
    "FastaFile", "write_fasta", "reverse_complement", "complement",
    "BamReader", "BamRecord", "write_bam",
    "clip_read_to_window",
    "resolve_bam_inputs", "extract_spanning_reads", "subsample_reads",
]
