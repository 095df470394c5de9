from .io import (
    DataReader,
    DataWriter,
    DummyDataWriter,
    FanoutDataWriter,
    FileBasedDataReader,
    FileBasedDataWriter,
    MemoryDataWriter,
)

__all__ = [
    "DataReader",
    "DataWriter",
    "DummyDataWriter",
    "FanoutDataWriter",
    "FileBasedDataReader",
    "FileBasedDataWriter",
    "MemoryDataWriter",
]
