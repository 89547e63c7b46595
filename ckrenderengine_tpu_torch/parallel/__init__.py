"""Many render contexts on one card (``context_batch``)."""
