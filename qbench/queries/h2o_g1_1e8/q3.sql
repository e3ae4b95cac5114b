SELECT id3, sum(v1) AS v1, avg(v3) AS v3 FROM source GROUP BY id3;
