"""The PyTorch port's copy of the JAX package's
``scripts/make_persona_corpus.py`` (numpy only; the same JSON bytes for
the same arguments). Generate a structured synthetic PersonaChat corpus in
the REAL release format (``personachat_self_original.json``: {"train":
[...], "valid": [...]}, entries with "personality" +
"utterances"/"history"/"candidates", gold last —
reference CommEfficient/data_utils/fed_persona.py:95-123 consumes exactly
this shape), sized for multi-hundred-round federated convergence runs.

The environment has no network, so the real 17,568-personality corpus can't
be downloaded; this stands in with a corpus that is *learnable*, not random:

- each personality draws a topic; its persona sentences and its gold replies
  share that topic's noun pool, while distractor candidates come from a
  different topic — so both the LM loss (topical word prediction) and the
  dialogue structure carry signal a model can descend on, and the
  sketched-vs-uncompressed gap is measured against a nontrivial objective;
- sentences come from a small template grammar over ~300 distinct words
  (near-injective under the offline HashTokenizer's 8192 crc32 buckets).

Usage: python -m commefficient_torch.scripts.make_persona_corpus OUT_DIR
           [--n_train 256] [--n_valid 32] [--seed 17]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

TOPIC_NOUNS = {
    "cooking": ["pasta", "bread", "soup", "spices", "recipes", "baking",
                "pancakes", "stew", "salad", "curry", "noodles", "pie"],
    "hiking": ["trails", "mountains", "forests", "boots", "summit", "maps",
               "rivers", "valleys", "campfires", "tents", "ridges", "peaks"],
    "music": ["guitar", "piano", "drums", "concerts", "melodies", "bands",
              "violin", "songs", "chords", "albums", "jazz", "opera"],
    "gardening": ["roses", "tomatoes", "soil", "seeds", "tulips", "herbs",
                  "compost", "orchids", "pumpkins", "ferns", "ivy", "moss"],
    "astronomy": ["stars", "planets", "telescopes", "comets", "galaxies",
                  "nebulae", "orbits", "moons", "eclipses", "meteors",
                  "constellations", "satellites"],
    "painting": ["canvas", "brushes", "watercolors", "portraits", "easels",
                 "sketches", "murals", "pigments", "landscapes", "ink",
                 "charcoal", "frames"],
    "fishing": ["trout", "rods", "lakes", "bait", "salmon", "reels",
                "docks", "lures", "ponds", "bass", "nets", "streams"],
    "chess": ["openings", "endgames", "knights", "bishops", "gambits",
              "tournaments", "checkmate", "pawns", "rooks", "tactics",
              "puzzles", "clocks"],
    "cycling": ["wheels", "pedals", "helmets", "races", "gears", "roads",
                "sprints", "tires", "descents", "climbs", "routes",
                "saddles"],
    "pottery": ["clay", "glazes", "kilns", "bowls", "vases", "wheels",
                "mugs", "plates", "sculptures", "slips", "molds", "tiles"],
    "sailing": ["sails", "knots", "harbors", "winds", "anchors", "decks",
                "masts", "tides", "buoys", "regattas", "hulls", "charts"],
    "baking": ["cookies", "cakes", "muffins", "dough", "frosting", "ovens",
               "croissants", "tarts", "scones", "yeast", "sugar", "flour"],
    "photography": ["cameras", "lenses", "portraits", "sunsets", "film",
                    "tripods", "shadows", "exposures", "prints", "studios",
                    "flashes", "angles"],
    "skiing": ["slopes", "powder", "lifts", "lodges", "moguls", "poles",
               "goggles", "glaciers", "chalets", "bindings", "runs",
               "drifts"],
    "birdwatching": ["owls", "herons", "finches", "binoculars", "nests",
                     "warblers", "hawks", "feathers", "migrations",
                     "sparrows", "cranes", "eagles"],
    "woodworking": ["oak", "chisels", "joints", "planes", "sawdust",
                    "lathes", "walnut", "cabinets", "dovetails", "maple",
                    "benches", "carvings"],
}

PERSONA_TEMPLATES = [
    "i really love {n}",
    "my favorite thing is {n}",
    "i spend weekends with {n}",
    "i think about {n} daily",
]
STATEMENT_TEMPLATES = [
    "the {n} were wonderful today",
    "i found some great {n} yesterday",
    "tell me about your {n}",
    "my {n} keep getting better",
    "we should talk about {n}",
    "have you tried new {n} lately",
]
REPLY_TEMPLATES = [
    "yes i adore {n} and {m}",
    "honestly {n} beat {m} every time",
    "my {n} pair nicely with {m}",
    "i learned about {n} from {m}",
]


def _sent(rng, templates, nouns):
    t = templates[rng.randint(len(templates))]
    picks = rng.choice(nouns, size=2, replace=False)
    return t.format(n=picks[0], m=picks[1])


def make_personality(rng, topic, n_utterances=6, num_candidates=2):
    nouns = TOPIC_NOUNS[topic]
    other_topics = [t for t in TOPIC_NOUNS if t != topic]
    personality = [_sent(rng, PERSONA_TEMPLATES, nouns)
                   for _ in range(4)]
    utterances = []
    history = []
    for _ in range(n_utterances):
        history = history + [_sent(rng, STATEMENT_TEMPLATES, nouns)]
        distractors = [
            _sent(rng, REPLY_TEMPLATES,
                  TOPIC_NOUNS[other_topics[rng.randint(len(other_topics))]])
            for _ in range(num_candidates - 1)]
        gold = _sent(rng, REPLY_TEMPLATES, nouns)
        utterances.append({"history": list(history),
                           "candidates": distractors + [gold]})
        history = history + [gold]
    return {"personality": personality, "utterances": utterances}


def make_corpus(n_train=256, n_valid=32, seed=17):
    rng = np.random.RandomState(seed)
    topics = list(TOPIC_NOUNS)
    blob = {}
    for split, n in (("train", n_train), ("valid", n_valid)):
        blob[split] = [make_personality(rng, topics[i % len(topics)])
                       for i in range(n)]
    return blob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--n_train", type=int, default=256)
    ap.add_argument("--n_valid", type=int, default=32)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    blob = make_corpus(args.n_train, args.n_valid, args.seed)
    fn = os.path.join(args.out_dir, "personachat_self_original.json")
    with open(fn, "w") as f:
        json.dump(blob, f)
    n_ut = sum(len(p["utterances"]) for p in blob["train"])
    print(f"wrote {fn}: {len(blob['train'])} train personalities "
          f"({n_ut} utterances), {len(blob['valid'])} valid")
    return fn


if __name__ == "__main__":
    main()
