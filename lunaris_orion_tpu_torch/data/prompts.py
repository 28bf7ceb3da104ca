"""Combinatorial prompt engine for dataset synthesis (the port's own copy
of lunaris_orion_tpu/data/prompts.py: the same banks and the same draws
from `random.Random(seed)`, so one seed gives the same prompts).

Same mechanism as the reference's PixelArtGenerator prompt system
(generate.py:57-777): 10 weighted categories, style/color/detail/lighting
banks, per-category modifier banks and template variants (the reference's
per-category template functions, generate.py:664-777), a special-token
template `[CATEGORY]...[STYLE]...[DETAIL]...[COLOR]...[END]` capped at 77
whitespace tokens, per-category generation parameters, and prompt
de-duplication. Bank *content* here is original (the mechanism is the
contract, not the word lists).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

MAX_PROMPT_TOKENS = 77

# category -> sampling weight (reference: generate.py:67-78)
CATEGORY_WEIGHTS: Dict[str, float] = {
    "character": 0.18,
    "monster": 0.14,
    "item": 0.12,
    "weapon": 0.10,
    "environment": 0.10,
    "building": 0.09,
    "food": 0.08,
    "vehicle": 0.07,
    "nature": 0.07,
    "effect": 0.05,
}

SUBJECTS: Dict[str, List[str]] = {
    "character": [
        "knight", "wizard", "rogue", "archer", "paladin", "bard",
        "alchemist", "monk", "ranger", "necromancer", "pirate",
        "astronaut", "samurai", "villager", "merchant", "blacksmith",
        "druid", "sorceress", "gladiator", "jester", "huntress",
        "shaman", "squire", "oracle", "beastmaster", "tinkerer",
        "falconer", "cartographer", "gravekeeper", "lamplighter",
    ],
    "monster": [
        "slime", "goblin", "dragon whelp", "skeleton", "ghost",
        "mimic chest", "giant spider", "imp", "golem", "wyvern",
        "kraken spawn", "zombie", "harpy", "basilisk", "gargoyle",
        "troll", "banshee", "sand worm", "frost elemental", "bog hag",
        "cursed armor", "will-o-wisp", "rat king", "cave bat swarm",
        "stone guardian", "ooze colossus", "spore walker", "void moth",
    ],
    "item": [
        "health potion", "ancient scroll", "rune stone", "golden key",
        "treasure chest", "magic ring", "crystal orb", "spell book",
        "compass", "hourglass", "lantern", "amulet", "coin pouch",
        "skeleton key", "dream catcher", "music box", "voodoo doll",
        "telescope", "ink quill", "wax-sealed letter", "dice set",
        "alchemy flask", "prayer beads", "signet stamp", "star chart",
    ],
    "weapon": [
        "longsword", "battle axe", "enchanted bow", "war hammer",
        "twin daggers", "magic staff", "halberd", "flail",
        "crossbow", "katana", "spear", "mace", "scythe", "rapier",
        "throwing knives", "morning star", "glaive", "chakram",
        "blunderbuss", "whip sword", "tower shield", "boomerang",
    ],
    "environment": [
        "forest clearing", "mountain pass", "desert oasis",
        "frozen lake", "lava cavern", "mushroom grove",
        "coastal cliff", "swamp", "canyon", "meadow", "bamboo thicket",
        "glacier field", "salt flat", "tide pool", "thorn maze",
        "geyser basin", "sunken ruin", "cloud plateau", "ash waste",
        "firefly marsh",
    ],
    "building": [
        "stone castle", "wooden tavern", "wizard tower",
        "windmill", "blacksmith forge", "chapel", "lighthouse",
        "cottage", "fortress gate", "market stall", "clocktower",
        "observatory", "water mill", "granary", "guard post",
        "apothecary shop", "bathhouse", "toll bridge", "bell tower",
        "greenhouse dome",
    ],
    "food": [
        "roasted turkey", "berry pie", "cheese wheel", "honey jar",
        "grilled fish", "bread loaf", "mushroom stew", "candy apple",
        "pumpkin soup", "chocolate cake", "skewered shrimp",
        "plum dumpling", "herb omelette", "spiced cider", "rice ball",
        "fig tart", "sausage platter", "pickle barrel", "noodle bowl",
        "gingerbread man",
    ],
    "vehicle": [
        "sailing ship", "horse cart", "hot air balloon",
        "steam locomotive", "rowboat", "war chariot", "airship",
        "mine cart", "submarine", "sled", "penny-farthing",
        "gondola", "paddle steamer", "caravan wagon", "glider kite",
        "ice yacht", "ornithopter", "siege tower", "ferry raft",
        "moon buggy",
    ],
    "nature": [
        "oak tree", "rose bush", "cactus", "waterfall",
        "crystal formation", "bonsai", "sunflower", "coral reef",
        "boulder", "vine lattice", "willow tree", "lotus pond",
        "amber deposit", "lichen stone", "pine sapling", "kelp column",
        "dandelion puff", "ivy archway", "stalagmite cluster",
        "moss carpet",
    ],
    "effect": [
        "fire burst", "ice shard", "lightning bolt", "poison cloud",
        "healing aura", "portal swirl", "smoke puff", "star sparkle",
        "shockwave ring", "shadow wisp", "arcane sigil", "ember trail",
        "frost nova", "wind slash", "gravity well", "prism beam",
        "thorn eruption", "echo ripple",
    ],
}

# Per-category modifier banks (the reference's category template functions
# mix in poses/materials/conditions, generate.py:664-777; content original).
MODIFIERS: Dict[str, List[str]] = {
    "character": ["standing idle", "mid swing", "casting a spell",
                  "walking cycle pose", "guarding stance", "celebrating",
                  "wounded and kneeling", "carrying a pack", "saluting",
                  "sneaking low", "reading a map", "raising a banner"],
    "monster": ["snarling", "lurking in shadow", "mid leap",
                "sleeping curled up", "split into two", "armored hide",
                "glowing eyes", "dripping slime", "crumbling apart",
                "hypnotic gaze", "burrowing up", "tiny and harmless"],
    "item": ["pristine condition", "cracked and worn", "softly glowing",
             "wrapped in cloth", "floating and rotating", "half buried",
             "locked shut", "overflowing", "miniature sized",
             "gilded edges", "covered in dust", "dripping wet"],
    "weapon": ["freshly forged", "battle worn", "runes etched along it",
               "wreathed in flame", "frost coated", "ceremonial gold trim",
               "stuck in a stone", "crossed in display", "oversized",
               "jeweled hilt", "chipped edge", "wrapped grip"],
    "environment": ["at dawn", "under heavy rain", "in thick fog",
                    "first snowfall", "autumn leaves falling",
                    "spring bloom", "during a sandstorm", "under starlight",
                    "after a storm", "dry season", "aurora overhead",
                    "fireflies drifting"],
    "building": ["freshly built", "abandoned and overgrown",
                 "under construction", "decorated for a festival",
                 "snow on the roof", "smoke from the chimney",
                 "lanterns lit", "half ruined", "fortified with barricades",
                 "ivy covered", "market day crowd", "night watch posted"],
    "food": ["steaming hot", "freshly baked", "half eaten",
             "on a wooden plate", "wrapped to go", "giant sized",
             "bite sized", "garnished with herbs", "drizzled with sauce",
             "stacked high", "picnic spread", "street stall serving"],
    "vehicle": ["at full speed", "docked and idle", "under repair",
                "loaded with cargo", "brand new paint", "rusted hull",
                "racing trim", "armored plating", "festively decorated",
                "abandoned wreck", "setting off at dawn", "caught in wind"],
    "nature": ["in full bloom", "winter bare", "morning dew",
               "swaying in wind", "overgrown wild", "neatly pruned",
               "struck by lightning", "home to small birds",
               "glowing faintly", "ancient and gnarled", "newly sprouted",
               "reflected in water"],
    "effect": ["small and contained", "screen filling", "spiraling outward",
               "double cast", "fizzling out", "charged to burst",
               "chained between points", "orbiting slowly",
               "mirrored symmetry", "flickering unstable"],
}

# Template variants per prompt (the reference rotates phrasing per category;
# the special-token envelope is the fixed contract).
_TEMPLATES = [
    "pixel art of a {mod} {subject}",
    "pixel art sprite, {subject}, {mod}",
    "{subject} {mod}, game asset sprite",
]

STYLES = ["16-bit retro", "8-bit minimal", "modern pixel", "isometric",
          "chibi", "dark fantasy", "pastel", "neon arcade", "monochrome",
          "painterly pixel", "1-bit stark", "gameboy green", "vaporwave",
          "steampunk brass", "storybook", "cyberpunk grit"]

DETAILS = ["clean outlines", "dithered shading", "high contrast",
           "soft gradients", "chunky pixels", "fine details",
           "bold silhouette", "textured surfaces", "hatched shadows",
           "selective outlines", "anti-aliased curves", "flat cel shading"]

COLORS = ["vibrant palette", "muted earth tones", "cool blues",
          "warm sunset hues", "forest greens", "royal purples",
          "fiery reds", "icy whites", "golden yellows", "twilight tones",
          "bubblegum pinks", "desert ochres", "deep sea teals",
          "lavender haze", "copper and rust", "mint and cream"]

LIGHTING = ["flat lighting", "dramatic side light", "ambient glow",
            "backlit rim light", "torch-lit", "moonlit", "noon sun",
            "magical luminescence", "candlelight flicker", "overcast soft",
            "neon underglow", "dappled canopy light"]


@dataclass(frozen=True)
class CategoryParams:
    """Per-category diffusion knobs (reference generate.py:180-241)."""
    guidance_scale: float
    pag_scale: float
    num_steps: int
    pixel_size: int


CATEGORY_PARAMS: Dict[str, CategoryParams] = {
    "character": CategoryParams(7.5, 3.0, 30, 8),
    "monster": CategoryParams(7.5, 3.0, 30, 8),
    "item": CategoryParams(7.0, 2.5, 25, 8),
    "weapon": CategoryParams(7.0, 2.5, 25, 8),
    "environment": CategoryParams(6.5, 2.0, 35, 4),
    "building": CategoryParams(6.5, 2.0, 30, 4),
    "food": CategoryParams(7.0, 2.5, 25, 8),
    "vehicle": CategoryParams(7.0, 2.5, 30, 8),
    "nature": CategoryParams(6.5, 2.0, 25, 4),
    "effect": CategoryParams(8.0, 3.5, 20, 8),
}


def combination_count(category: str) -> int:
    """Distinct prompts constructible for a category (diversity metric)."""
    return (len(SUBJECTS[category]) * len(MODIFIERS[category])
            * len(_TEMPLATES) * len(STYLES) * len(DETAILS) * len(COLORS)
            * len(LIGHTING))


class PromptEngine:
    def __init__(self, seed: Optional[int] = None):
        self.rng = random.Random(seed)
        self.seen: set = set()

    def pick_category(self) -> str:
        cats, ws = zip(*CATEGORY_WEIGHTS.items())
        return self.rng.choices(cats, weights=ws, k=1)[0]

    def build_prompt(self, category: Optional[str] = None) -> Tuple[str, str]:
        """Returns (prompt, category). Template + 77-token cap
        (generate.py:57-64, 664-777)."""
        category = category or self.pick_category()
        subject = self.rng.choice(SUBJECTS[category])
        mod = self.rng.choice(MODIFIERS[category])
        body = self.rng.choice(_TEMPLATES).format(subject=subject, mod=mod)
        style = self.rng.choice(STYLES)
        detail = self.rng.choice(DETAILS)
        color = self.rng.choice(COLORS)
        light = self.rng.choice(LIGHTING)
        prompt = (f"[CATEGORY]{category}[SUBJECT]{body}"
                  f"[STYLE]{style} style, {light}"
                  f"[DETAIL]{detail}[COLOR]{color}[END]")
        tokens = prompt.split()
        if len(tokens) > MAX_PROMPT_TOKENS:
            prompt = " ".join(tokens[:MAX_PROMPT_TOKENS])
        return prompt, category

    def unique_prompt(self, category: Optional[str] = None,
                      max_tries: int = 50) -> Tuple[str, str]:
        """De-duplicated prompt (generate.py:782-792)."""
        for _ in range(max_tries):
            prompt, cat = self.build_prompt(category)
            if prompt not in self.seen:
                self.seen.add(prompt)
                return prompt, cat
        return prompt, cat  # exhausted: allow a duplicate

    @staticmethod
    def params_for(category: str) -> CategoryParams:
        return CATEGORY_PARAMS[category]
