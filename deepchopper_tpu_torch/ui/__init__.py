"""Web UI: the single-record demo (its core runs without gradio)."""
