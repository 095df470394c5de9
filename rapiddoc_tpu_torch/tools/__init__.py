"""ONNX protobuf reading and writing, numpy only."""
