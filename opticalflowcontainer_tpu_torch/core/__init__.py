"""Device selection and the cv2-parity image primitives the flow path uses."""
