"""Runtime helpers of the PyTorch port: device selection and lane names."""
