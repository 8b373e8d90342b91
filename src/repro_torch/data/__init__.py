"""The synthetic token pipeline (numpy only, no torch: search workers
import the package)."""
