"""Data reader/writer abstractions.

API-compatible with the reference data layer
(reference: rapid_doc/data/data_reader_writer/base.py, filebase.py):
same class names and method shapes so downstream code ports over
unchanged. Copy of the JAX package's module without its HTTP and S3
readers and writers.
"""
from __future__ import annotations

import os
from abc import ABC, abstractmethod
from pathlib import Path


class DataReader(ABC):
    def read(self, path: str) -> bytes:
        return self.read_at(path)

    @abstractmethod
    def read_at(self, path: str, offset: int = 0, limit: int = -1) -> bytes:
        ...


class DataWriter(ABC):
    @abstractmethod
    def write(self, path: str, data: bytes) -> None:
        ...

    def write_string(self, path: str, data: str) -> None:
        self.write(path, data.encode("utf-8"))


class FileBasedDataReader(DataReader):
    def __init__(self, parent_dir: str = ""):
        self._parent_dir = parent_dir

    def read_at(self, path: str, offset: int = 0, limit: int = -1) -> bytes:
        fn = path if os.path.isabs(path) else os.path.join(self._parent_dir, path)
        with open(fn, "rb") as f:
            f.seek(offset)
            return f.read() if limit == -1 else f.read(limit)


class FileBasedDataWriter(DataWriter):
    def __init__(self, parent_dir: str = ""):
        self._parent_dir = parent_dir

    def write(self, path: str, data: bytes) -> None:
        fn = path if os.path.isabs(path) else os.path.join(self._parent_dir, path)
        Path(fn).parent.mkdir(parents=True, exist_ok=True)
        with open(fn, "wb") as f:
            f.write(data)


class MemoryDataWriter(DataWriter):
    def __init__(self, parent_dir: str = "images") -> None:
        self._parent_dir = parent_dir
        self.data: dict[str, bytes] = {}

    def write(self, path: str, data: bytes) -> None:
        self.data[path.replace("\\", "/")] = data

    def get_value(self) -> dict[str, bytes]:
        return self.data


class FanoutDataWriter(DataWriter):
    def __init__(self, *writers: DataWriter | None) -> None:
        self._writers = [w for w in writers if w is not None]
        self._parent_dir = next(
            (getattr(w, "_parent_dir", "") for w in self._writers
             if getattr(w, "_parent_dir", "")),
            "",
        )

    def write(self, path: str, data: bytes) -> None:
        for w in self._writers:
            w.write(path, data)


class DummyDataWriter(DataWriter):
    def write(self, path: str, data: bytes) -> None:
        pass
