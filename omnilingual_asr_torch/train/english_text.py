"""English sentence bank: grammatical word order for English synth draws.

The base corpus draws words i.i.d. from a Pareto-indexed lexicon
(train/synth.py make_example), which is fine for the cipher languages but
leaves synthetic English as word salad. Real English (the reference's
actual input domain, gemini_pipeline.py:512-530) has strong sequential
structure — function-word rhythm, stress alternation, collocations — that
shapes both the acoustics (reduction, phrasing) and what a decode-time LM
can do. This bank provides original, simple, grammatical sentences built
from high-frequency vocabulary (train/synth.py ENGLISH_WORDS register plus
the formal register of the bundled recording), and a cropping sampler that
respects the trainer's word-count curriculum.

The sentences are original compositions for this corpus — none reproduce
the bundled recording's held-out text.

The PyTorch port's own copy of ``omnilingual_asr_tpu/train/english_text.py``
(numpy only; the port imports nothing of the JAX package); keep the two in
step. The decoding lexicon (``ops/lexicon.py``) reads the bank's words.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["SENTENCES", "sample_sentence", "english_bank_words"]

SENTENCES: List[str] = [s.strip() for s in """
the old man walked down to the water every morning
she said that the work would be done before night
we came here to see the great house on the hill
they could not find the way back through the dark wood
a new school was built near the river last year
he told them the story of the first people of this land
the children play in the field behind the small white house
each year the men of the town meet under the old tree
you must learn to read before you can write well
the sound of the sea came up through the open window
her father gave her a book about the far side of the world
we hold these things to be true and good
the long war took many brave men from their homes
those who came before us made this country with their hands
no man can take from you what you have learned
the light of the morning sun fell on the quiet field
they gave their lives so that others might live free
it is right and proper that we remember them
the living must finish the work the dead began
a house divided against itself cannot stand long
the people of this nation want peace and a fair measure of hope
great men have spoken here and the world has listened
the power of a free people is greater than any army
we cannot forget what they did on this ground
let every man and woman stand up and be counted
the full measure of their devotion will never be forgotten
a government of the people must also answer to the people
liberty is not given it is won and held by each new age
the birth of a nation is a long and hard struggle
these honored dead shall not have died in vain
the unfinished work of the living is to increase what is good
from these fields a new freedom took its first breath
the brave men who struggled here have made this place holy
far above our poor power to add or take away
the world will little note what we say here today
it is for us to be dedicated to the great task before us
four good men stood watch through the long cold night
the captain brought his men home across the high mountain
under the law all people stand equal before the court
she carried the water up from the well three times a day
the teacher asked each child to name the parts of a plant
my mother grew corn and beans on the south side of the farm
the boat came in slow against the strong evening wind
he cut the wood and she built the fire
there was bread and milk on the table when we came home
the doctor said the boy would walk again by spring
every bird in the wood sang at first light
the train runs from the city to the coast twice a day
hard work and a little luck made the farm what it is
the price of corn fell and the family had a hard winter
they crossed the river where the water runs slow and wide
a long road goes from the town up into the blue hills
the young men left the village to look for work in the city
nothing grows in that field but dry grass and stones
the letter came after many weeks and brought good news
she opened the window to let in the warm spring air
the king sent men to every corner of the land
a wise man listens more than he speaks
the study of the stars is as old as the first people
water finds its own way down through the smallest opening
the machine can do the work of twenty strong men
we measure a year by the turning of the earth
the moon pulls the sea up the sand and back again
each word you write should carry its own weight
a good story begins in one small true thing
the artist drew the mountain as the light changed
music filled the square and the people began to dance
the bank stands at the corner of the main street
the box held letters from a war long past
her answer was short but it was the right one
the game ended when the rain came down hard
he kept the small stone in his pocket for luck
the dog ran ahead and waited at the top of the path
they planted trees along both sides of the new road
the fire burned low and the talk turned to old times
a cold wind came off the lake in the late fall
the ship carried wool and timber to the far ports
she learned three languages before she was twelve
the map showed a pass through the high country
the well ran dry in the seventh year
every family in the valley lost something in the flood
the bell rang once and the children ran to the school door
bread was scarce that winter and the nights were long
the old bridge still carries the weight of the morning traffic
he wrote his name slowly at the bottom of the page
the court heard the case for three full days
light from the small lamp fell across the open book
the men worked the field from first light to dark
a single tree stood in the middle of the wide plain
the road turns left past the church and runs to the sea
they found fresh water two days after the storm
the house at the end of the lane has stood empty for years
his hands knew the work better than his eyes
the harvest came early and the barns were full
snow closed the mountain road before the first of the month
the river gives and the river takes away
she kept a garden of herbs beside the kitchen door
the committee will meet again when the report is ready
the evidence points to a simple and human answer
a question well asked is half answered
the value of land rises where the water is clean
the new law takes effect at the start of the year
every voice in the room fell silent when she stood
the history of this valley is written in its stone walls
wind and rain wear down even the hardest rock
the plan called for a school a road and a deep well
he paid his debt in full and walked out a free man
the picture shows the family standing before the old house
time moves slowly for those who wait by the sea
the first snow fell soft and silent on the empty street
a friend in hard times is worth more than gold
the answer lay in the last line of the letter
they set the stones one by one until the wall was done
the city grew up around the crossing of two rivers
nothing in the report was new but all of it was true
the last boat left the harbor before the storm broke
she read the names aloud one by one in the cold air
the field where they fought is quiet now and green
men came from every state to stand on that ground
what we do here will be weighed by those who come after
the cost of freedom is counted in common lives
a people who forget their dead forget themselves
the speech was short but no one who heard it forgot it
courage is fear that has said its prayers and gone to work
the flag still stood when the smoke cleared at dawn
peace came at last and the soldiers walked home through the fields
the widow kept the farm and raised four children alone
history does not repeat but it often rhymes
the vote was counted twice and the result stood
each generation must earn its liberty again
the union held because plain people would not let it fall
they buried the unknown soldier on the hill above the river
the general wrote one letter home every single night
a short life given for others is not a small life
the school stands where the old camp used to be
we teach the children the names so the names will live
the monument faces east toward the rising sun
stone can hold a name but only we can hold a meaning
the old soldier spoke softly about the friends of his youth
the land remembers what the books leave out
a promise made in public is a debt to all who heard it
the long winter ended and the land turned green again
hope is a small fire that must be fed every day
the town rebuilt the bridge in a single summer
let the record show that they did their duty
the years pass but the ground keeps its story
the last witness died and the letters became the only voice
their names are cut in stone above the door
what began in anger ended in a handshake at a farm gate
the treaty was signed in a small room without ceremony
the bells rang in every town from the coast to the hills
""".splitlines() if s.strip()]


def sample_sentence(rng: np.random.Generator, *,
                    min_words: int = 3,
                    max_words: Optional[int] = None) -> str:
    """Draw one sentence, cropped to a random contiguous word window that
    respects the [min_words, max_words] budget (curriculum contract)."""
    words = SENTENCES[int(rng.integers(len(SENTENCES)))].split()
    hi = len(words) if max_words is None else min(len(words), max_words)
    lo = min(min_words, len(words))
    n = int(rng.integers(lo, hi + 1)) if hi > lo else hi
    start = int(rng.integers(0, len(words) - n + 1))
    return " ".join(words[start:start + n])


def english_bank_words() -> "set[str]":
    """Vocabulary of the bank (for the decoding lexicon, ops/lexicon.py)."""
    out: "set[str]" = set()
    for s in SENTENCES:
        out.update(s.split())
    return out
