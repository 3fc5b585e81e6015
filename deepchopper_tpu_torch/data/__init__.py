"""FASTQ -> tokenized, length-bucketed fixed-shape batches."""
