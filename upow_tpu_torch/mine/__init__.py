"""Mining on the card: template → batched nonce-search kernel → push_block."""

from .engine import MiningJob, MineResult, mine, NONCE_SPACE
