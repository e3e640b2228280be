"""Each cell at a size the CPU runs in seconds, in float32 (the same
geometry as the cells': 1080p-like frames cut by 3 to the input)."""

TINY = {
    "r50y8n-fused-stream-1080p": {
        "config": {"input_size": 64, "dtype": "float32", "max_detections": 16,
                   "calibration_traffic": {"height": 96, "width": 192, "detail_px": 8,
                                           "squares": 1, "square_px_min": 8,
                                           "square_px_max": 20}},
        "traffic": {"height": 96, "width": 192, "batch": 2, "pool_batches": 2, "squares": 1,
                    "square_px_min": 8, "square_px_max": 20, "held_batches": 2,
                    "held_min_batches": 3, "detail_px": 8},
    },
    "r50-train-640-b32": {
        "config": {"input_size": 64, "compute_dtype": "float32", "batch_size": 4, "max_gt": 8},
        "traffic": {"height": 96, "width": 192, "images": 12, "face_px_min": 8,
                    "face_px_max": 30, "detail_px": 8},
    },
}
SEED = 2**31 + 11  # past 32 signed bits, as the check's seeds are
SECONDS = 2.0
