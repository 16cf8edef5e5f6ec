"""The deployed enhance function, ONNX weight import and frame streaming."""
