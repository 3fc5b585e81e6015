"""FASTQ input and prediction-shard output."""
