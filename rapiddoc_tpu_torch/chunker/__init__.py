"""RAG chunking (reference: chunker/ package)."""
from .text_splitters import (
    MarkdownTextSplitter,
    chunk_with_bboxes,
    split_markdown,
)

__all__ = ["MarkdownTextSplitter", "chunk_with_bboxes", "split_markdown"]
